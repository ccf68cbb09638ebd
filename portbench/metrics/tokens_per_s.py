"""Output tokens emitted inside the window, over the window's seconds."""
from portbench.harness import stats


def read(run):
    w = run.window
    return stats.tokens_in(w.reqs, w.t_open, w.t_close) \
        / (w.t_close - w.t_open)
