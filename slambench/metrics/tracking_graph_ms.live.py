"""Device milliseconds per frame in the tracking program's replays from the
graph's first node to its last (its ``program`` span: no host work inside
the replay call counts), summed over the window, over its frames."""

from slambench import program_spans


def read(trace):
    return program_spans.span_ms(trace, "tracking", "program")
