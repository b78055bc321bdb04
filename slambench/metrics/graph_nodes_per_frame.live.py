"""Graph nodes executed per frame by the replays of both step programs,
counted on the device (each conditional body's nodes once per execution of
its node, the top level once per replay), over the window's frames."""

from slambench import program_spans


def read(trace):
    return program_spans.graph_nodes_per_frame(trace)
