"""The kidnap of tests/test_torch_graphs_reloc.py in ``reloc_parity=True``
mode: up to eight candidates in keyframe-insertion order (sorted on the
device), each under ``live & ~won`` with EPnP and its own top-up cascade,
through the step programs in select mode against the eager run, bit for
bit."""

from torch_slam_helpers import kidnap_graph_vs_eager


def test_kidnap_parity_select_bit_equal_to_eager():
    a, _ = kidnap_graph_vs_eager(reloc_parity=True)
    assert a.reloc_frames[0] == 11
