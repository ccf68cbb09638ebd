"""AdamW with f32 moments (PyTorch port of ``repro.train.optimizer``).

Moments are f32 whatever the parameter's dtype; the learning rate, the
bias corrections and the update are f32, as in the reference. The update
runs leaf by leaf in place (parameters and moments are overwritten), with
at most two f32 temporaries of a leaf alive at once, and keeps the
reference's operation order, so its rounding is the reference's.

Weight decay applies where the reference's leaf has two or more
dimensions. The reference stacks a segment's periodic layers into leaves
with a leading layer axis, so its stacked layer norms (``(n_periods,
d)``) are decayed and its unstacked ones (``final_norm``, the Engram
``norm``, the norms of a segment's unrolled prefix) are not. The port
keeps one leaf per layer, so ``decay_mask(cfg)`` reads the decision from
the reference's layout (``segment_plan``), not from the port's shapes.

``opt_state_axes`` maps parameter logical axes to the moments' (ZeRO-1's
"opt" axis on the first unsharded dim), the reference's layout of them,
and the port's sharded train step holds the moments so: ``zero_dims``
says along which dim of a rank's parameter block its moments are split
over "data", and ``init_opt_state(params, zero)`` makes those slices.

Under a mesh a rank holds blocks of some leaves: ``global_norm`` and
``adamw_update`` then take ``split`` (``sharding.rules.split_axes_tree``:
each leaf's path -> the mesh axes it is split over) and sum each leaf's
squares over those axes, counting a repeated leaf once.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.params import tree_leaves, tree_map, tree_paths


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(c: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of ``lr``: an
    f32 scalar on ``step``'s device (a Python int gives a CPU tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(c.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - c.warmup_steps) / max(c.decay_steps, 1), 0.0,
                    1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = c.min_lr_frac + (1 - c.min_lr_frac) * cos
    return c.lr * warm * frac


def init_opt_state(params, zero: dict | None = None) -> dict:
    """Zero f32 moments beside each leaf, on its device, and step 0 (an
    int32 scalar on the first leaf's device). ``zero`` (``zero_dims``):
    the leaves are a rank's blocks and each moment is the rank's slice of
    its block along the dim ZeRO-1 splits it over "data"."""
    from ..sharding.rules import current_ctx
    dev = next(tree_leaves(params)).device
    zero = zero or {}

    def zeros(path, p):
        shape = list(p.shape)
        if path in zero:
            dim, axes = zero[path]
            shape[dim] //= current_ctx().axis_prod(axes)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def moments():
        return with_paths(params, zeros)
    return {"m": moments(), "v": moments(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def with_paths(tree, fn, prefix: str = ""):
    """``fn(path, leaf)`` over a tree, in its structure (paths as
    ``tree_paths`` names them)."""
    if isinstance(tree, dict):
        return {k: with_paths(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [with_paths(v, fn, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def zero_dims(like, param_axes, ctx) -> dict:
    """path -> (dim, mesh axes): for each leaf of the whole tree ``like``
    whose moments ``opt_state_axes`` splits further than the parameter
    under ``ctx`` (ZeRO-1's "opt" on a dim the parameter keeps whole and
    the axes divide, over more than one rank), that dim and the axes it
    is split over."""
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        a is None or isinstance(a, str) for a in x)
    pa = dict(tree_paths(param_axes, is_leaf=is_axes))
    ma = dict(tree_paths(opt_state_axes(param_axes)["m"], is_leaf=is_axes))
    out = {}
    for path, t in tree_paths(like):
        shape = tuple(t.shape)
        ps = ctx.spec_for(shape, pa[path])
        ms = ctx.spec_for(shape, ma[path])
        ps = ps + (None,) * (len(ms) - len(ps))
        for dim, (a, b) in enumerate(zip(ps, ms)):
            axes = (b,) if isinstance(b, str) else tuple(b or ())
            if a != b and ctx.axis_prod(axes) > 1:
                out[path] = (dim, axes)
    return out


def abstract_opt_state(params_abstract) -> dict:
    """``init_opt_state``'s shapes and dtypes on the ``meta`` device."""
    z = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                       device="meta"), params_abstract)
    return {"m": z, "v": z,
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def opt_state_axes(param_axes) -> dict:
    """Param logical axes -> moment axes with ZeRO's "opt" on the first
    unsharded dim, except where the parameter already uses the data axis
    (the pooled Engram table, sharded over every axis)."""
    from ..sharding.rules import Fused

    def one(axes):
        if "eng_vocab" in axes:
            return axes
        out, done = [], False
        for a in axes:
            if a is None and not done:
                out.append("opt")
                done = True
            else:
                out.append(a)
        if isinstance(axes, Fused):
            return Fused(out, axes.parts, axes.dim)
        return tuple(out)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return one(tree)

    mapped = walk(param_axes)
    return {"m": mapped, "v": mapped, "step": ()}


def decay_mask(cfg) -> dict:
    """Per leaf of ``cfg``'s parameter tree: True where the reference
    decays it, i.e. where the reference's leaf has two or more dims. A
    block of a segment's stacked tail (``period > 0``, past
    ``prefix_len``) counts the reference's leading layer axis."""
    from ..models.model import model_defs
    from ..models.transformer import segment_plan
    defs = model_defs(cfg)
    mask = tree_map(lambda d: len(d.shape) >= 2, defs)
    for seg, blocks, out in zip(segment_plan(cfg), defs["segments"],
                                mask["segments"]):
        if seg.period:
            for j in range(seg.prefix_len, len(seg.layers)):
                out[j] = tree_map(lambda d: len(d.shape) + 1 >= 2, blocks[j])
    return mask


def _sq(x):
    x = x.reshape(-1).float()
    return torch.dot(x, x)


def global_norm(tree, split=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (each leaf's sum a
    dot product with itself: no squared copy). With ``split`` (path ->
    mesh axes, see the module docstring) the tree holds this rank's
    blocks: each leaf's squares are summed over the axes it is split
    over, one collective per set of axes, so every rank gets the whole
    tree's norm."""
    if split is None:
        return torch.sqrt(sum(_sq(x) for x in tree_leaves(tree)))
    from ..sharding import collectives as coll
    groups = {}
    for path, x in tree_paths(tree):
        axes = split[path]
        groups[axes] = groups.get(axes, 0) + _sq(x)
    return torch.sqrt(sum(coll.psum(v, axes) if axes else v
                          for axes, v in groups.items()))


@torch.no_grad()
def adamw_update(c: AdamWConfig, params, grads, state, decay=None,
                 split=None):
    """One AdamW step, in place: ``params`` and ``state``'s moments are
    overwritten and its ``step`` advanced. ``decay`` is ``decay_mask``'s
    tree (None: decay where the port's leaf has two or more dims, the
    reference's rule read on this tree as it is). ``split``: the leaves
    are this rank's blocks (``global_norm``). Returns (params, state,
    {grad_norm, lr}), the metrics f32 scalars on the parameters' device."""
    step = state["step"]
    gnorm = global_norm(grads, split)
    scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if c.grad_clip > 0 else 1.0
    lr = schedule(c, step)
    b1, b2 = c.b1, c.b2
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    # the trees are matched by path, not by order: a dict's key order
    # may differ between trees built different ways
    grads, ms, vs = (dict(tree_paths(x)) for x in (grads, state["m"],
                                                    state["v"]))
    decay = {} if decay is None else dict(tree_paths(decay))
    for path, p in tree_paths(params):
        g, m, v = grads[path], ms[path], vs[path]
        dec = decay.get(path, p.ndim >= 2)
        # two f32 temporaries: a is g, then delta; b the other operands
        a = g.to(torch.float32, copy=True).mul_(scale)
        b = torch.mul(a, 1 - b1)
        m.mul_(b1).add_(b)                       # b1 * m + (1 - b1) * g
        torch.mul(a, 1 - b2, out=b).mul_(a)
        v.mul_(b2).add_(b)                       # b2 * v + (1 - b2) * g * g
        torch.div(m, bc1, out=a)                 # mhat
        torch.div(v, bc2, out=b).sqrt_().add_(c.eps)
        a.div_(b)                                # delta
        if c.weight_decay > 0 and dec:
            b.copy_(p).mul_(c.weight_decay)
            a.add_(b)
        a.mul_(lr)
        p.copy_(b.copy_(p).sub_(a))              # p - lr * delta
    state["step"] = step + 1
    return params, state, {"grad_norm": gnorm, "lr": lr}
