"""Slot-batched decode-state surgery for continuous batching (PyTorch port
of ``repro.serving.slots``: ``update_slots``, ``select_slots``,
``gate_state``, ``snapshot_recurrent``, ``rollback_state``,
``extract_prefix`` and ``restore_prefix``; ``reset_slot`` does in place
what the reference's scatter of a zeroed batch-1 state does).

The port's decode state is a nested dict/list of tensors whose batch axis
is always axis 0 (per-layer caches, no stacked layer axes), and whose KV
leaves (``k``/``v``, shape (B, S, H, D); MLA's latents ``c_kv``/``k_rope``,
(B, S, R)) have their sequence axis at 1, so no per-leaf axis bookkeeping
is needed. Every other cache leaf is recurrent state (Mamba's ``conv`` and
``ssm``; mLSTM's ``conv``, ``C``, ``n``, ``m``; sLSTM's ``conv``, ``c``,
``n``, ``h``, ``m``), which has no positional identity. Slot ids are host
integers: the reference lets pad rows scatter to the out-of-bounds slot
``B`` and relies on JAX dropping the write; here those rows are dropped on
the host before the scatter.

``gate_state`` is chunked prefill's per-row gate: a chunk wave unrolls C
decode steps over rows with ragged valid lengths, and a row past its
length must not advance. Every leaf but the KV caches is gated per row:
``positions``, ``last_tokens`` and the recurrent leaves (the decode step
returns new recurrent tensors, so the old ones are still there to keep).
KV leaves keep the new buffers, as in the reference: an invalid row's
garbage write lands at its un-advanced ``positions[b]``, and the row's
next real step writes that same index before it attends there, so the
garbage is never read. (The port's decode writes K/V in place, so a
``torch.where`` over them would only copy every cache per step.)
``reset_slot`` clears a slot for a fresh prompt: its position, last
tokens and recurrent leaves, in place.

``snapshot_recurrent`` / ``rollback_state`` truncate rejected speculation
per slot: the verify pass records the state's non-KV leaves after every
unrolled step, and each slot is re-selected at its kept step count by
device-side indexing (no host read). KV leaves keep the final buffers: rows
past a slot's rewound ``positions`` are masked and later overwritten in
place. A snapshot holds the recurrent leaves by reference, which is sound
because the decode step never updates them in place.

``extract_prefix`` / ``restore_prefix`` are block-granular KV restore at a
prefill offset: one slot's state goes to the host with its KV sliced to
the first ``length`` positions (the prefix-cache snapshot), and comes back
padded out to decode capacity, ready for ``update_slots`` into a free
slot.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import upload
from ..models.model import KV_KEYS, pad_kv
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


def _map_named(fn, tree, name=None):
    """``tree_map`` that also passes each leaf's nearest dict key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(fn, v, name) for v in tree]
    return fn(name, tree)


def _map_named_zip(fn, tree, others, name=None):
    """``_map_named`` over ``tree`` and same-shaped ``others`` together:
    ``fn(name, leaf, [matching leaf of each other])``."""
    if isinstance(tree, dict):
        return {k: _map_named_zip(fn, v, [o[k] for o in others], k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named_zip(fn, v, [o[i] for o in others], name)
                for i, v in enumerate(tree)]
    return fn(name, tree, others)


def snapshot_recurrent(state):
    """Per-step snapshot for speculative rollback: every leaf but the KV
    caches (which become None), by reference: the decode step makes new
    ``positions``/``last_tokens`` and recurrent tensors, so no copy is
    needed."""
    return _map_named(lambda name, leaf: None if name in KV_KEYS else leaf,
                      state)


def rollback_state(final_state, snapshots, n_keep: torch.Tensor):
    """Truncate rejected speculation per slot.

    ``final_state``: the state after the whole m-step verify pass.
    ``snapshots``: m+1 ``snapshot_recurrent`` trees; ``snapshots[s]`` is the
    state after s verify steps (s = 0 before the verify).
    ``n_keep (B,)``: a device tensor of verify steps to keep per slot, in
    [0, m]. Non-KV leaves are re-selected at ``snapshots[n_keep[b]]`` for
    every slot b by indexing on the device; KV leaves keep the final
    buffers."""
    sel = n_keep.long()
    rows = torch.arange(sel.shape[0], device=sel.device)

    def one(name, leaf, snap_leaves):
        if name in KV_KEYS:
            return leaf
        return torch.stack(snap_leaves)[sel, rows]      # batch axis 0

    return _map_named_zip(one, final_state, snapshots)


def gate_state(valid, new_state, old_state):
    """Per-row gate for one unrolled step: rows with ``valid (B,)`` true
    keep ``new_state``, the others keep ``old_state``'s ``positions``,
    ``last_tokens`` and recurrent leaves. KV leaves are ``new_state``'s
    (written in place; see the module docstring)."""
    def one(name, new, old):
        if name in KV_KEYS:
            return new
        gate = valid.view((-1,) + (1,) * (new.ndim - 1))
        return torch.where(gate, new, old[0])

    return _map_named_zip(one, new_state, [old_state])


def reset_slot(state, slot: int, pad_token: int) -> None:
    """Clear host slot ``slot`` for a fresh prompt, in place: position 0,
    ``last_tokens`` set to ``pad_token``, recurrent leaves zeroed. The
    previous occupant's KV needs no clearing (masked past the position,
    overwritten before it is attended). ``fill_``, not item assignment:
    assigning a Python number to a CUDA tensor's element syncs."""
    def one(name, leaf):
        if name not in KV_KEYS:
            leaf[slot].fill_(pad_token if name == "last_tokens" else 0)
        return leaf

    _map_named(one, state)


def extract_prefix(state, slot: int, length: int):
    """Host snapshot of slot ``slot`` at prefill offset ``length``: a
    batch-1 tree of CPU tensors (not numpy, which has no bfloat16), KV
    leaves sliced to ``[:length]``.
    Returns ``(snapshot, nbytes)``; ``nbytes`` is what a prefix-cache spill
    or fetch moves over the pool link, counted leaf by leaf as the
    reference counts it (``positions``/``last_tokens`` are int32 in both).
    Reads the device once per leaf: the caller accounts for the sync."""
    def one(name, leaf):
        sub = leaf[slot:slot + 1]
        if name in KV_KEYS:
            sub = sub[:, :length]
        return sub.to("cpu", copy=True)    # never a view of the state

    snap = _map_named(one, state)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(snap))
    return snap, nbytes


def restore_prefix(snapshot, max_len: int, device: torch.device):
    """Device tree from an ``extract_prefix`` snapshot, uploaded with
    ``device.upload``; KV leaves are padded with zeros back to ``max_len``
    positions (masked by ``positions`` until overwritten)."""
    def one(name, leaf):
        t = upload(leaf, device)
        return pad_kv(t, max_len) if name in KV_KEYS else t

    return _map_named(one, snapshot)
