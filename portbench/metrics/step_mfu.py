"""Model FLOPs of every prompt and output token the window processed, over
the card's bf16 peak times the window, in % (``portbench/roofline``).
The FLOPs are the configuration's family's (``harness/family.py``: by
default ``roofline.flops``). A prompt counts when its first token comes
inside the window, an output token's decode step when the token does."""
from portbench.roofline import peaks


def read(run):
    c, w, fam = run.config, run.window, run.family
    total = 0.0
    for r in w.reqs:
        for i, t in enumerate(r.stamps):
            if not w.t_open < t <= w.t_close:
                continue
            if i == 0:
                total += fam.prefill(c, len(r.prompt))
            else:
                total += fam.decode(c, len(r.prompt) + i - 1)
    return 100.0 * total / (peaks.BF16_FLOP_PER_S * (w.t_close - w.t_open))
