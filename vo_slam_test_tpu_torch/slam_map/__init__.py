"""Device-resident SLAM map: state, insertion, local-map search, culling,
triangulation and fusion (port of ``vo_slam_test_tpu/slam_map``)."""
