"""SlamSystem(vocabulary=None, chunk=4) through its step programs on the CPU
(select form under ``no_host_reads``) against the eager run, bit for bit:
K tracking steps, then the chunk's stops on the device and K background
steps in ``background_chunk``'s order (see test_torch_graphs_system.py)."""

from test_torch_graphs_system import graph_vs_eager_room


def test_slam_system_select_bit_equal_to_eager_chunk4():
    graph_vs_eager_room(chunk=4)
