"""Slot-batched decode-state surgery for continuous batching (PyTorch port
of ``repro.serving.slots``: ``update_slots`` and ``select_slots``).

The port's decode state is a nested dict/list of tensors whose batch axis
is always axis 0 (per-layer caches, no stacked layer axes), so no per-leaf
axis bookkeeping is needed. Slot ids are host integers: the reference lets
pad rows scatter to the out-of-bounds slot ``B`` and relies on JAX dropping
the write; here those rows are dropped on the host before the scatter.
"""
from __future__ import annotations

import numpy as np

from ..device import upload
from ..models.params import tree_leaves, tree_map


def _zip_leaves(a, b):
    """(leaf of a, matching leaf of b) pairs of two same-shaped trees."""
    if isinstance(a, dict):
        for k in a:
            yield from _zip_leaves(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (len(a), len(b))
        for x, y in zip(a, b):
            yield from _zip_leaves(x, y)
    else:
        yield a, b


def update_slots(state, new_state, slots):
    """Write rows of ``new_state`` (batch k) into ``state`` (batch B) at the
    host slot ids ``slots`` (k,), IN PLACE; rows whose slot is >= B are
    dropped. Returns ``state``."""
    slots = np.asarray(slots, np.int64)
    first = next(tree_leaves(state))
    keep = np.nonzero(slots < first.shape[0])[0]
    dst = upload(slots[keep], first.device)
    src = upload(keep, first.device)
    for leaf, new in _zip_leaves(state, new_state):
        leaf.index_copy_(0, dst, new.index_select(0, src).to(leaf.dtype))
    return state


def select_slots(state, slots):
    """The sub-state of host slot ids ``slots`` (a gathered copy); ids past
    the batch read the last slot, as the reference's clamped gather."""
    first = next(tree_leaves(state))
    idx = np.minimum(np.asarray(slots, np.int64), first.shape[0] - 1)
    idx = upload(idx, first.device)
    return tree_map(lambda leaf: leaf.index_select(0, idx), state)
