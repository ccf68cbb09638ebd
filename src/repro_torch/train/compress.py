"""Int8-compressed gradient all-reduce (PyTorch port of
``repro.train.compress``).

The all-reduce is decomposed into a reduce-scatter and an all-gather, and
both wire passes carry int8:

    quantize(g / n) -> all_to_all (int8) -> widen and sum locally
    -> requantize the reduced chunk -> all_gather (int8) -> dequantize

Per-tensor symmetric scales ride along as f32 side channels. The error is
bounded by max|g| / 127 per element and a pass. The collectives run on the
process groups of the current mesh (``sharding.collectives``, under
``sharding.rules.sharding_ctx``). ``compressed_psum.wire`` counts the
wire collectives by (name, dtype), so a run can show that the payloads
went as int8 (the reference reads its lowered HLO for that).
"""
from __future__ import annotations

import collections

import torch

from ..models.params import tree_map
from ..sharding import collectives as coll
from ..sharding.rules import current_ctx


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q int8, scale f32 scalar)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _group_size(axes) -> int:
    ctx = current_ctx()
    if ctx is None:
        raise ValueError("a collective needs a sharding context")
    return ctx.mesh.group(axes).size()


def compressed_psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` with an int8 wire; a
    new tensor in ``x``'s dtype and shape."""
    n = _group_size(axes)
    if n == 1:
        return x
    shape, dt = x.shape, x.dtype
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    # mean contribution (divide before quant: keeps the int8 range tight)
    q, scale = quantize(flat / n)
    # reduce-scatter pass: int8 wire
    recv = _wire("all_to_all", coll.all_to_all, q.view(n, -1), axes)
    scales = coll.all_gather(scale, axes)                      # (n,) f32
    part = torch.sum(recv.float() * scales[:, None], dim=0)    # (m,)
    # all-gather pass: requantize the reduced chunk, int8 wire
    q2, s2 = quantize(part)
    full_q = _wire("all_gather", coll.all_gather, q2, axes)    # (n, m)
    full_s = coll.all_gather(s2, axes)                         # (n,)
    out = (full_q.float() * full_s[:, None]).reshape(-1)
    if pad:
        out = out[:-pad]
    return (out * n).reshape(shape).to(dt)                     # undo /n


def _wire(name: str, fn, x: torch.Tensor, axes) -> torch.Tensor:
    compressed_psum.wire[(name, str(x.dtype))] += 1
    return fn(x, axes)


compressed_psum.wire = collections.Counter()


def compressed_pmean_tree(tree, axes):
    n = _group_size(axes)
    return tree_map(lambda x: compressed_psum(x, axes) / n, tree)
