"""The kidnap of tests/test_torch_graphs_reloc.py with depth-poor return
frames: relocalization solves EPnP (its 12x12 eigenproblem and the control
points' 3x3 on the port's eigensolver), through the step programs in select
mode against the eager run, bit for bit."""

from torch_slam_helpers import kidnap_graph_vs_eager


def test_kidnap_depth_poor_select_bit_equal_to_eager():
    a, _ = kidnap_graph_vs_eager(depth_poor=True)
    assert a.reloc_frames[0] == 11
