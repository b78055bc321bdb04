"""Percent of the window on the card's clock in which neither step program
ran: 100 (1 - the replays' event spans summed / the window)."""


def read(trace):
    w = trace.window
    if not w.track_ms or w.device_ms <= 0:
        return None
    return 100.0 * (1.0 - (sum(w.track_ms) + sum(w.background_ms)) / w.device_ms)
