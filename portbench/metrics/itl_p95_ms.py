"""95th percentile of every gap between consecutive output tokens of a
request inside the window (a gap still open at the close counts as its
length so far), in ms."""
from portbench.harness import stats


def read(run):
    g = stats.gaps(run.window.reqs, run.window.t_open, run.window.t_close)
    return 1e3 * stats.percentile(g, 95) if g else None
