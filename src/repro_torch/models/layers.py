"""Common layers: RMSNorm, RoPE, MLP, embeddings, softcap, f32 head
(PyTorch port of ``repro.models.layers``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

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


def value_counts(x: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(x, minlength=n)`` for int values known to lie in
    [0, n): the same int64 counts, in a tensor whose length is ``n``
    whatever the values (bincount's is ``max(x) + 1`` when that is larger,
    so a fake or meta trace cannot pass it), with no device->host read."""
    x = x.reshape(-1)
    return torch.zeros(n, dtype=torch.int64, device=x.device).index_add_(
        0, x, torch.ones(x.shape, dtype=torch.int64, device=x.device))


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


def chunked_xent(head_params, h: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None, *, final_cap: float = 0.0,
                 tied: bool = False, chunk: int = 2048,
                 remat_body: bool = False) -> torch.Tensor:
    """h (B,S,d); labels (B,S) int; mean softmax cross-entropy over
    ``mask`` (all positions when None), an f32 scalar.

    The f32 logits of ``chunk`` positions at a time go through the head
    (``head_logits``: softcap, tied head), so the (tokens, vocab) logits
    never materialise at once; the token axis is zero-padded to a whole
    number of chunks with mask 0, as the reference pads. The head's f32
    weight is cast once and shared by every chunk. ``remat_body``
    checkpoints each chunk (``torch.utils.checkpoint``), so backward
    recomputes its logits instead of keeping every (chunk, vocab) block."""
    B, S, D = h.shape
    T = B * S
    hf = h.reshape(T, D)
    lf = labels.reshape(T).long()
    mf = torch.ones(T, dtype=torch.float32, device=h.device) if mask is None \
        else mask.reshape(T).float()
    pad = (-T) % chunk
    if pad:
        hf = F.pad(hf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad))
        mf = F.pad(mf, (0, pad))
    w = head_params["w"].float()
    head = {"w32": w.T if tied else w}

    def body(hx, lx, mx):
        logits = head_logits(head, hx, final_cap)              # (chunk, V)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(1, lx[:, None])[:, 0]
        return ((logz - gold) * mx).sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, T + pad, chunk):
        xs = (hf[i:i + chunk], lf[i:i + chunk], mf[i:i + chunk])
        if remat_body:
            tot = tot + torch.utils.checkpoint.checkpoint(
                body, *xs, use_reentrant=False)
        else:
            tot = tot + body(*xs)
    return tot / mf.sum().clamp(min=1.0)
