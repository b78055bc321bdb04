"""Device milliseconds per frame in the tracking program: the CUDA events
around each replay of ``track_graph``, summed over the window, over its frames."""


def read(trace):
    w = trace.window
    return sum(w.track_ms) / w.frames if w.track_ms else None
