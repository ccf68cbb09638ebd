"""Abstract input specs and one rank's blocks for every (arch x shape) cell
(PyTorch port of ``repro.launch.specs``).

``input_specs`` and ``abstract_decode_state`` return fake tensors
(``FakeTensorMode``: shapes, dtypes and a device, nothing allocated; on
the meta device plain meta tensors) with the reference's shapes and
dtypes, the counterpart of its ``ShapeDtypeStruct`` stand-ins. The
reference's ``*_shardings`` build ``NamedSharding`` trees; the port
places nothing, so its ``state_shardings``, ``batch_shardings`` and
``param_shardings`` return the rank's block shapes (``ShardCtx.
spec_for``), and ``rank_blocks`` makes fake tensors of those shapes:
what one rank holds.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import init_decode_state, params_logical_axes
from ..models.params import tree_map
from ..models.transformer import RunFlags
from ..sharding.rules import ShardCtx, use_ctx


def fake_mode(device="cuda"):
    """The mode one trace on ``device`` runs under, every tensor of the
    trace made in it: a ``FakeTensorMode`` for a real device, none for
    the meta device, whose tensors hold no data already (and trace about
    three times faster than fake ones)."""
    if torch.device(device).type == "meta":
        return contextlib.nullcontext()
    return FakeTensorMode()


def _fake(mode, shape, dtype, device) -> torch.Tensor:
    with mode:
        return torch.empty(tuple(shape), dtype=dtype, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="cuda",
                mode=None) -> dict:
    """Model inputs for one step of the given kind (fake tensors on
    ``device``, made in ``mode``)."""
    mode = mode or fake_mode(device)
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32

    def spec(shp, dt):
        return _fake(mode, shp, dt, device)

    if shape.kind == "train":
        specs = {"tokens": spec((B, S), i32), "labels": spec((B, S), i32)}
    elif shape.kind == "prefill":
        specs = {"tokens": spec((B, S), i32), "lengths": spec((B,), i32)}
    elif shape.kind == "decode":
        # one new token against a KV cache of seq_len
        return {"token": spec((B,), i32)}
    else:
        raise ValueError(shape.kind)
    if cfg.frontend == "audio":
        specs["frames"] = spec((B, S, cfg.frontend_dim), f32)
    if cfg.frontend == "vision":
        specs["patches"] = spec((B, cfg.n_patch_tokens, cfg.frontend_dim),
                                f32)
    return specs


def abstract_decode_state(cfg: ModelConfig, flags: RunFlags, batch: int,
                          max_len: int, device="cuda", mode=None):
    """``init_decode_state``'s whole tree (outside any sharding context)
    as fake tensors."""
    with mode or fake_mode(device), use_ctx(None):
        return init_decode_state(cfg, flags, batch, max_len, device)


# logical axes for state leaves, keyed by leaf name (suffix dims)
_STATE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "c_kv": ("batch", "kv_seq", None),
    "k_rope": ("batch", "kv_seq", None),
    "conv": ("batch", None, "ffn"),
    "ssm": ("batch", "ffn", None),
    "C": ("batch", "heads", None, None),
    "n": ("batch", "heads", None),
    "m": ("batch", "heads"),
    "c": ("batch", "heads", None),
    "h": ("batch", "heads", None),
    "positions": ("batch",),
    "last_tokens": ("batch", None),
}


def state_axes(state):
    """The logical axes of every leaf of a decode state, keyed by the
    leaf's name as the reference's ``state_shardings`` keys them (the
    last dict key above it): the named suffix dims, the rest None."""
    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, key) for v in tree]
        axes = _STATE_AXES.get(key, ())
        nd = tree.dim()
        if nd < len(axes):
            return tuple(axes)[-nd:] if nd else ()
        return (None,) * (nd - len(axes)) + tuple(axes)
    return walk(state, None)


def block_shape(shape, logical_axes, ctx: ShardCtx) -> tuple:
    """The shape of one rank's block of a tensor of ``shape`` under
    ``logical_axes`` (the reference's ``NamedSharding.shard_shape``)."""
    return ctx.block_shape(shape, logical_axes)


def _zip(fn, tree, other):
    """``fn(leaf, other's leaf)`` over a tree of tensors and a tree of its
    structure (whose leaves may be tuples)."""
    if isinstance(tree, dict):
        return {k: _zip(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def state_shardings(state, ctx: ShardCtx, axes=None):
    """The rank's block shape of every leaf of a decode state under
    ``axes`` (default ``state_axes(state)``, the reference's layout, which
    the port's steps hold: KV caches split over "kv_heads", recurrent
    state over "ffn" and "heads", each where the axis divides the dim)."""
    axes = state_axes(state) if axes is None else axes
    return _zip(lambda t, ax: block_shape(t.shape, ax, ctx), state, axes)


def batch_shardings(specs: dict, ctx: ShardCtx) -> dict:
    """The rank's block shape of every batch input (split on "batch")."""
    return {k: block_shape(v.shape, ("batch",) + (None,) * (v.dim() - 1),
                           ctx) for k, v in specs.items()}


def param_shardings(cfg: ModelConfig, ctx: ShardCtx, axes=None):
    """The rank's block shape of every parameter under ``axes`` (default
    ``params_logical_axes(cfg)``, the reference's; the port's forward
    holds ``models.model.mesh_logical_axes``, its train step
    ``train_logical_axes``: the same but for ``WHOLE_LEAVES``)."""
    from ..models.model import abstract_params
    axes = params_logical_axes(cfg) if axes is None else axes
    return _zip(lambda t, ax: block_shape(t.shape, ax, ctx),
                abstract_params(cfg), axes)


def rank_blocks(tree, shapes, mode, device="cuda"):
    """Fake tensors of the block ``shapes`` (a tree of tuples of
    ``tree``'s structure), each of its leaf's dtype: what the rank holds,
    each block its own storage."""
    return _zip(lambda t, shp: _fake(mode, shp, t.dtype, device),
                tree, shapes)


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a tree."""
    total = 0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        return t
    tree_map(add, tree)
    return total


__all__ = ["abstract_decode_state", "batch_shardings", "block_shape",
           "fake_mode", "input_specs", "param_shardings",
           "rank_blocks", "state_axes", "state_shardings", "tree_bytes"]
