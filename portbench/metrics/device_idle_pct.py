"""One minus the union of every kernel, copy and fill interval over the
traced window, in %."""


def read(run):
    t = run.trace
    if t is None:
        return None
    span = t["window_ns"][1] - t["window_ns"][0]
    return 100.0 * (1.0 - t["busy_ns"] / span) if span > 0 else None
