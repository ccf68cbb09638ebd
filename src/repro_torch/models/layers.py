"""Common layers: RMSNorm, RoPE, MLP, embeddings, softcap, f32 head
(PyTorch port of ``repro.models.layers``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding import collectives as coll
from ..sharding.rules import current_ctx, rank_block
from .params import pd


def rmsnorm_defs(d: int):
    return {"scale": pd(d, init="ones")}


def mlp_defs(d: int, f: int, dtype: str, fan_in: int = 0):
    return {"gate": pd(d, f, axes=(None, "ffn"), dtype=dtype, fan_in=fan_in),
            "up": pd(d, f, axes=(None, "ffn"), dtype=dtype, fan_in=fan_in),
            "down": pd(f, d, axes=("ffn", None), dtype=dtype, fan_in=fan_in)}


def embed_defs(vocab: int, d: int, dtype: str):
    return {"w": pd(vocab, d, axes=("vocab", None), dtype=dtype, scale=1.0)}


def head_defs(vocab: int, d: int, dtype: str):
    return {"w": pd(d, vocab, axes=(None, "vocab"), dtype=dtype)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 compute, result in ``x.dtype``."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)            # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) w/ positions (..., S). Half-split rotation
    ``[x1·cos − x2·sin, x2·cos + x1·sin]`` over the two halves of D (not
    the interleaved-pairs form)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (``act="silu"``) or GeGLU with the tanh-approximate GELU."""
    g = x @ params["gate"]
    u = x @ params["up"]
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (a * u) @ params["down"]


def embed_lookup(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["w"][tokens]


def embed_lookup_local(params, tokens: torch.Tensor,
                       vocab: int | None = None) -> torch.Tensor:
    """Vocab-sharded embedding gather: each rank takes the tokens that fall
    in its block of rows (zeros elsewhere) and the ranks of the vocab axes
    sum them (``all_reduce``), so only the (tokens x d_model) result moves,
    never the table. ``vocab`` is the table's whole row count when
    ``params["w"]`` is the rank's block (None: ``w`` is whole; a whole
    table is read in its rank's block). Without a mesh, with one rank on
    the vocab axes or a vocabulary they do not divide, it is
    ``embed_lookup`` (the table then whole), as in the reference."""
    ctx = current_ctx()
    w = params["w"]
    V = vocab or w.shape[0]
    axes = tuple(a for a in ctx.rules.get("vocab", ())
                 if a in ctx.mesh.axis_names) if ctx else ()
    if ctx is None or not axes:
        return embed_lookup(params, tokens)
    n = ctx.axis_prod(axes)
    if n == 1 or V % n != 0:
        return embed_lookup(params, tokens)
    v_loc = V // n
    w = rank_block(w, 0, V, axes, ctx)
    rel = tokens - coll.axis_index(axes) * v_loc
    ok = (rel >= 0) & (rel < v_loc)
    rows = w[rel.clamp(0, v_loc - 1)] * ok[..., None].to(w.dtype)
    return coll.psum(rows, axes)


def scale_embeddings(h: torch.Tensor, d_model: int) -> torch.Tensor:
    """``h * sqrt(d_model)`` with the constant rounded to ``h.dtype`` first,
    as JAX rounds the reference's weakly typed Python float (in bf16,
    sqrt(4608) = 67.88 becomes 68.0)."""
    return h * torch.tensor(math.sqrt(d_model), dtype=h.dtype).item()


def with_f32_head(params: dict) -> dict:
    """Shallow copy of a param tree whose head also holds an f32 copy of its
    weight (``w32``, (d, V)), made once: ``head_logits`` computes in f32,
    and casting a bf16 head per call would allocate the f32 copy on every
    step. A tree without a ``head`` is tied: its ``embed`` holds ``w32``,
    the transposed f32 embedding. A tree that already holds ``w32`` comes
    back as it is, so engines built from one prepared tree (the router's
    replicas) share one f32 head; an f32 weight is shared, not copied
    (``.float()`` returns it)."""
    tied = "head" not in params
    key = "embed" if tied else "head"
    head = params[key]
    if "w32" in head:
        return params
    w32 = head["w"].float()
    out = dict(params)
    out[key] = dict(head, w32=w32.T if tied else w32)
    return out


def head_logits(params, h: torch.Tensor, final_cap: float = 0.0,
                tied: bool = False) -> torch.Tensor:
    """f32 logits ``h.float() @ W.float()``; with ``tied``, ``params`` is
    the embedding and ``W`` its transpose."""
    w = params.get("w32")
    if w is None:
        w = params["w"].float()
        if tied:
            w = w.T
    return softcap(h.float() @ w, final_cap)
