"""Loops whose every iteration runs the same operations on the same
shapes: a recurrent mixer's scan over positions and chunked attention's
loop over KV blocks.

At the dry run's sequence lengths such a loop runs tens of thousands of
small operations a layer. ``launch.dryrun`` installs a sampler
(``sampling``; ``roofline.counting.sample_loops`` makes it) under which
``trips`` runs only the first k + 1 iterations of a loop over fake or
meta tensors and leaves the counting of the rest to the sampler. A loop
over real tensors always runs every iteration, whatever is installed, so
sampling never changes a computed answer. The sampler is process-wide,
as the fake world it serves is: a CUDA backward recomputes a remat
period's loops on the autograd engine's thread.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import is_fake

_SAMPLER = None     # an object with ``k`` and ``loop(n)``, or None


@contextlib.contextmanager
def sampling(sampler):
    """Sample the loops over fake or meta tensors run inside: ``sampler.k``
    iterations after the first, each run inside ``sampler.loop(n)``,
    which counts them for the n - 1 not all run and may yield a function
    each of them begins with (None: nothing to call)."""
    global _SAMPLER
    prev, _SAMPLER = _SAMPLER, sampler
    try:
        yield sampler
    finally:
        _SAMPLER = prev


def abstract(t: torch.Tensor) -> bool:
    """Whether ``t`` holds no data: a fake tensor or one on the meta
    device."""
    return t.device.type == "meta" or is_fake(t)


def trips(lo: int, hi: int, like: torch.Tensor):
    """The iterations ``range(lo, hi)`` of a loop computing on ``like``.
    Under a ``sampling`` sampler with k + 1 < hi - lo and ``like``
    abstract, only the first k + 1 run: the first (whose state may not
    require grad yet) as it is, the next k inside the sampler's loop."""
    s = _SAMPLER
    n = hi - lo
    if s is None or n <= s.k + 1 or not abstract(like):
        yield from range(lo, hi)
        return
    yield lo
    with s.loop(n) as begin:
        for i in range(lo + 1, lo + s.k + 1):
            if begin is not None:
                begin()
            yield i


def stack_positions(ys: list, n: int, dim: int) -> torch.Tensor:
    """``torch.stack(ys, dim)`` of a scan's n outputs; after a sampled
    scan (fewer than n), the last one stands in for the positions not run,
    so the result has its whole shape and is allocated whole."""
    if len(ys) < n:
        ys = ys + [ys[-1].detach()] * (n - len(ys))   # one alias, n - k refs
    return torch.stack(ys, dim=dim)


__all__ = ["abstract", "sampling", "stack_positions", "trips"]
