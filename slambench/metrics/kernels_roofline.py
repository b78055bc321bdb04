"""The hand kernels' share of their rooflines over the window, in percent: the
launches of each kernel counted on the device in the replays, each weighted by
its bound and by its time alone on the instance recorded at its call site
(``slambench/kernels.py``): 100 * sum(launches * bound ms) / sum(launches * ms)."""


def read(trace):
    if not trace.kernels or not trace.launches:
        return None
    bound = ms = 0.0
    for name, k in trace.kernels.items():
        n = trace.launches.get(name, 0)
        bound += n * k["bound_ms"]
        ms += n * k["ms"]
    return 100.0 * bound / ms if ms > 0 else None
