"""Bag-of-words vocabulary, BoW vectors and keyframe retrieval (port of
``vo_slam_test_tpu/bow``)."""
