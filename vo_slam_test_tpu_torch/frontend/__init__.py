"""ORB front end: extraction into fixed-shape FrameFeatures."""
