"""Device milliseconds per frame in the background program (mapping chain,
local BA, loop close): the CUDA events around each replay of
``background_graph``, summed over the window, over its frames."""


def read(trace):
    w = trace.window
    return sum(w.background_ms) / w.frames if w.background_ms else None
