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
    init: str = "normal"        # normal | ones | zeros
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


def _init_leaf(d: ParamDef, gen: torch.Generator, device: torch.device,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Draw leaf ``d`` on ``device``, chunk by chunk. With ``out`` (a host
    tensor mapped for the card) each chunk is drawn into one device buffer
    and copied down into ``out``, so the device never holds the whole leaf;
    the bytes are those of a draw without ``out`` (same generator calls on
    chunks of the same sizes)."""
    dtype = DTYPES[d.dtype]
    if out is not None and (tuple(out.shape) != d.shape or out.dtype != dtype):
        raise ValueError(f"host table {out.dtype} {tuple(out.shape)} for a "
                         f"{d.dtype} {d.shape} leaf")
    if d.init not in ("ones", "zeros", "normal"):
        raise ValueError(d.init)
    fan_in = d.fan_in or (d.shape[0] if d.shape else 1)
    scale = d.scale if d.scale >= 0 else 1.0 / math.sqrt(max(fan_in, 1))

    def draw(part):
        if d.init != "normal":
            part.fill_(1.0 if d.init == "ones" else 0.0)
        else:
            part.normal_(0.0, scale, generator=gen)

    if out is None:
        t = torch.empty(d.shape, dtype=dtype, device=device)
        flat = t.view(-1)
        for i in range(0, flat.numel(), _INIT_CHUNK):
            draw(flat[i:i + _INIT_CHUNK])
        return t
    flat = out.view(-1)
    chunk = torch.empty(min(flat.numel(), _INIT_CHUNK), dtype=dtype,
                        device=device)
    for i in range(0, flat.numel(), _INIT_CHUNK):
        part = chunk[:min(_INIT_CHUNK, flat.numel() - i)]
        draw(part)
        flat[i:i + part.numel()].copy_(part, non_blocking=True)
    return out


def tree_init(defs, seed: int = 0, device=None, host_leaves=None):
    """Materialise a def tree from one seeded ``torch.Generator`` on
    ``device``. The draws are not the reference's (``jax.random`` cannot be
    reproduced in torch); tests bridge the reference's weights instead.
    ``host_leaves`` maps ``id(def)`` to a mapped host tensor that leaf is
    drawn into (see ``_init_leaf``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    host_leaves = host_leaves or {}
    return tree_map(lambda d: _init_leaf(d, gen, dev, host_leaves.get(id(d))),
                    defs)


def to_torch(a, device: torch.device) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def table_memory_for(cfg, flags=None) -> str | None:
    """Where a run keeps its Engram tables, from the retrieval strategy it
    takes (``flags.engram_strategy``, else the config's): ``"pinned_host"``
    (pinned, device-mapped host memory) for ``pooled_host``, None (the
    parameters' device) for every other. Callers pass its answer to
    ``init_params(table_memory=)``, and ``serving.Engine`` refuses tables
    placed otherwise."""
    strategy = getattr(flags, "engram_strategy", None) or (
        cfg.engram.strategy if cfg.engram is not None else None)
    return "pinned_host" if strategy == "pooled_host" else None


def init_params(cfg, seed: int = 0, device=None, dtype=None,
                table_memory: str | None = None, host_tables=None):
    """Seeded random parameters for ``cfg`` drawn on ``device`` (the card
    unless the caller passes ``device="cpu"``), in ``dtype`` (default
    ``cfg.dtype``; norm scales stay f32 as in the reference).

    ``table_memory`` is ``table_memory_for``'s answer for the run:
    ``"pinned_host"`` puts every Engram layer's tables in
    pinned, device-mapped host memory (the ``pooled_host`` strategy's
    placement): each is still drawn on the card, chunk by chunk in the
    same generator order, and copied down, so its bytes equal a plain
    draw's and the card never holds a whole table set. ``host_tables``
    (one mapped host tensor per Engram layer, of the tables' shape) are
    filled in place instead of registering new buffers. On the CPU the
    tables are plain CPU tensors either way."""
    from .model import model_defs
    if table_memory not in (None, "pinned_host"):
        raise ValueError(f"table_memory {table_memory!r}: None or "
                         "'pinned_host'")
    defs = model_defs(cfg, dtype)
    dev = resolve_device(device)
    if table_memory is None or dev.type == "cpu" or "engram" not in defs:
        return tree_init(defs, seed, dev)
    from ..kernels.engram_gather.host import host_empty
    tdefs = [layer["tables"] for layer in defs["engram"]["layers"]]
    if host_tables is None:
        host_tables = [host_empty(d.shape, DTYPES[d.dtype]) for d in tdefs]
    if len(host_tables) != len(tdefs):
        raise ValueError(f"{len(host_tables)} host tables for "
                         f"{len(tdefs)} Engram layers")
    params = tree_init(defs, seed, dev, {id(d): h for d, h
                                          in zip(tdefs, host_tables)})
    torch.cuda.synchronize(dev)      # the host tables are written
    return params


def tables_to_host(params):
    """Move a tree's Engram tables from the card into new pinned, mapped
    host buffers, in place: each layer's ``tables`` leaf becomes its host
    copy, and the device copy is freed once nothing else holds it. Tables
    already on the CPU stay. Returns ``params``."""
    from ..kernels.engram_gather.host import host_empty
    for layer in params.get("engram", {}).get("layers", []):
        t = layer["tables"]
        if t.device.type == "cpu":
            continue
        layer["tables"] = host_empty(tuple(t.shape), t.dtype).copy_(t)
    return params


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
