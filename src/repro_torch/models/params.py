"""Parameter definitions, seeded initialisation and the bridge from the JAX
package's parameters (PyTorch port of ``repro.models.params``).

A model is described by a nested dict/list of ``ParamDef`` leaves. Where the
reference stacks a segment's periodic layers into one leaf with a leading
layer axis, the port keeps one leaf per layer; ``fan_in`` records the
reference's stacked fan-in so both draw from the same distribution
(normal · 1/sqrt(shape[0]) of the reference's leaf).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

# elements drawn per normal_ call: a full-width Engram table set holds
# 5.8 G elements, drawn in its own dtype chunk by chunk (no f32 copy)
_INIT_CHUNK = 1 << 28


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    dtype: str = "float32"
    init: str = "normal"        # normal | ones
    scale: float = -1.0         # -1 => 1/sqrt(fan_in)
    fan_in: int = 0             # 0 => shape[0]


def pd(*shape, dtype="float32", init="normal", scale=-1.0,
       fan_in=0) -> ParamDef:
    return ParamDef(tuple(shape), dtype, init, scale, fan_in)


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a nested dict/list tree, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def _init_leaf(d: ParamDef, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    t = torch.empty(d.shape, dtype=DTYPES[d.dtype], device=device)
    if d.init == "ones":
        return t.fill_(1.0)
    if d.init != "normal":
        raise ValueError(d.init)
    fan_in = d.fan_in or (d.shape[0] if d.shape else 1)
    scale = d.scale if d.scale >= 0 else 1.0 / math.sqrt(max(fan_in, 1))
    flat = t.view(-1)
    for i in range(0, flat.numel(), _INIT_CHUNK):
        flat[i:i + _INIT_CHUNK].normal_(0.0, scale, generator=gen)
    return t


def tree_init(defs, seed: int = 0, device=None):
    """Materialise a def tree from one seeded ``torch.Generator`` on
    ``device``. The draws are not the reference's (``jax.random`` cannot be
    reproduced in torch); tests bridge the reference's weights instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_map(lambda d: _init_leaf(d, gen, dev), defs)


def to_torch(a, device: torch.device) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def init_params(cfg, seed: int = 0, device=None, dtype=None):
    """Seeded random parameters for ``cfg`` drawn on ``device`` (the card
    unless the caller passes ``device="cpu"``), in ``dtype`` (default
    ``cfg.dtype``; norm scales stay f32 as in the reference)."""
    from .model import model_defs
    return tree_init(model_defs(cfg, dtype), seed, device)


def from_jax(np_tree, cfg, device=None):
    """The reference's ``init_params`` output (leaves as numpy arrays) ->
    the port's tree. The reference's scanned ``stack`` leaves, (n_periods,
    ...) per period position, are unstacked into one block per layer in
    layer order (``prefix``, then period by period)."""
    from .transformer import segment_plan
    dev = resolve_device(device)
    conv = lambda a: to_torch(a, dev)                     # noqa: E731
    segments = []
    for seg, sp in zip(segment_plan(cfg), np_tree["segments"]):
        blocks = [tree_map(conv, b) for b in sp["prefix"]]
        for r in range(seg.n_periods):
            for pos in range(seg.period):
                blocks.append(tree_map(lambda a: conv(np.asarray(a)[r]),
                                       sp["stack"][pos]))
        segments.append(blocks)
    return {k: segments if k == "segments" else tree_map(conv, v)
            for k, v in np_tree.items()}
