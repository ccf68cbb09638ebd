"""The window's arithmetic on the host stamps: tokens, inter-token gaps
and times to first token, with requests still open at the close counted
as what they have waited so far (censored), and a nearest-rank
percentile."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least q % of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def tokens_in(reqs, t0: float, t1: float) -> int:
    return sum(t0 < t <= t1 for r in reqs for t in r.stamps)


def gaps(reqs, t0: float, t1: float) -> list:
    """Every gap between consecutive tokens of a request that starts
    inside [t0, t1): its length, or, still open at t1, its length so far."""
    out = []
    for r in reqs:
        st = r.stamps
        for i, a in enumerate(st):
            if not t0 <= a < t1:
                continue
            if i + 1 < len(st):
                out.append(min(st[i + 1], t1) - a)
            elif r.t_done is None or r.t_done > t1:
                out.append(t1 - a)
    return out


def ttfts(reqs, t0: float, t1: float) -> list:
    """Submission to first token of every request submitted inside
    [t0, t1); one with no first token by t1 counts what it waited."""
    out = []
    for r in reqs:
        if t0 <= r.t_submit < t1:
            first = r.stamps[0] if r.stamps else math.inf
            out.append(min(first, t1) - r.t_submit)
    return out
