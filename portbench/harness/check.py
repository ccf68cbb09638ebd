"""The outputs check: the served tokens against the plain reference.

Once the window has closed (and the device's peak memory has been read and
the engine freed), a sample of the requests the window finished, drawn
from the seed and holding the longest of them, is run through the
reference once each, teacher-forced over the prompt and the served tokens.
At each served position the reference's logits give a gap: how far the
served token's logit lies below the reference's best, in units of the
standard deviation of that position's logits. The widest gap over the
sample is the number compared; a greedy server that computes what the
reference computes, up to its own rounding, serves near-ties only, where
the gap is small.

The control puts the reference in the program's place in float8 (e4m3)
products (``reference.common.Float8Linear``): at each position of the same
prompts and tokens, the token the float8 logits put first is read against
the float32 logits the same way.

The reference is the configuration's family's (``harness/family.py``):
``Ref(c, params, device, linear=None)`` with ``.logits(seqs, want)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference.common import Float8Linear


def sample(reqs: list, t_close: float, seed: int, tokens: int,
           max_reqs: int) -> list:
    """The finished requests checked: the longest (prompt and output),
    then others in an order drawn from ``seed`` until ``tokens`` served
    tokens or ``max_reqs`` requests."""
    done = [r for r in reqs if r.t_done is not None and r.t_done <= t_close]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens),
                                       r.t_submit))
    rest = [r for r in done if r is not longest]
    pick = [longest]
    n = len(longest.tokens)
    for i in np.random.default_rng([int(seed), 3]).permutation(len(rest)):
        if n >= tokens or len(pick) >= max_reqs:
            break
        pick.append(rest[i])
        n += len(rest[i].tokens)
    return pick


def _inputs(reqs: list) -> tuple:
    seqs = [r.prompt + r.tokens[:-1] for r in reqs]
    want = [np.arange(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.tokens))
            for r in reqs]
    return seqs, want


def gap_of(logits: torch.Tensor, tokens) -> torch.Tensor:
    """(best - logits[token]) / std, per position."""
    tok = torch.as_tensor(tokens, device=logits.device).view(-1, 1)
    top = logits.max(dim=-1).values
    return (top - logits.gather(1, tok)[:, 0]) / logits.std(dim=-1)


def served_gaps(Ref, c: dict, params, reqs: list, device) -> list:
    """Per checked request, the gap of each of its served tokens."""
    seqs, want = _inputs(reqs)
    ref = Ref(c, params, device).logits(seqs, want)
    return [gap_of(L, r.tokens).cpu() for L, r in zip(ref, reqs)]


def control_gaps(Ref, c: dict, params, reqs: list, device) -> tuple:
    """Per checked request, the gaps of its served tokens and those of the
    tokens the float8 reference puts first, from one pass of each
    reference."""
    seqs, want = _inputs(reqs)
    ref = Ref(c, params, device).logits(seqs, want)
    low = Ref(c, params, device, Float8Linear()).logits(seqs, want)
    served = [gap_of(R, r.tokens).cpu() for R, r in zip(ref, reqs)]
    return served, [gap_of(R, L.argmax(dim=-1)).cpu()
                    for R, L in zip(ref, low)]


def summary(gaps: list) -> dict:
    """The numbers a cell may compare, over the checked requests' gaps:
    ``widest_gap``, the largest; ``mean_gap``, the mean over every served
    position."""
    if not gaps:
        return {"widest_gap": None, "mean_gap": None}
    allg = torch.cat(gaps)
    return {"widest_gap": allg.max().item(), "mean_gap": allg.mean().item()}
