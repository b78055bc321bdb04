"""Device milliseconds per frame in the tracking program's ``bow`` span
(the stamps inside the captured graph), summed over the window's replays,
over its frames."""

from slambench import program_spans


def read(trace):
    return program_spans.span_ms(trace, "tracking", "bow")
