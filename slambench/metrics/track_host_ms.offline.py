"""Host milliseconds per frame inside ``SlamSystem.track`` (the entry point),
over every frame of the window."""


def read(trace):
    w = trace.window
    return sum(w.host_track_ms) / w.frames if w.frames else None
