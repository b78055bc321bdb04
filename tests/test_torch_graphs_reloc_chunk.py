"""The kidnap of tests/test_torch_graphs_reloc.py with ``chunk=4``: four
tracking replays, then four background replays (each followed by its read of
the loop candidates) in background_chunk's order, in select mode against
the eager chunked run, bit for bit."""

from torch_slam_helpers import kidnap_graph_vs_eager


def test_kidnap_chunk4_select_bit_equal_to_eager():
    a, _ = kidnap_graph_vs_eager(chunk=4)
    assert a.reloc_frames[0] == 11
