"""Common layers: RMSNorm, RoPE, MLP, embeddings, softcap, f32 head
(PyTorch port of ``repro.models.layers``).

Under a sharding context the layers run on the rank's blocks of the
reference's layout (``sharding.rules``): the MLP's hidden features split
over "ffn" (gate and up column-parallel, down row-parallel, one ``psum``
of the partial outputs), the embedding and the head over "vocab" (a
masked local gather summed over the axis; logits for the rank's block
of the vocabulary; a vocab-parallel cross-entropy). A layer's weights may
be given whole or as the rank's block (``mesh_blocks``); the whole sizes
come from its defs, and a dim the axis does not divide stays whole, as
in the reference. ``tp_cols`` gives a rank the columns it computes on
of an activation split over an axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..sharding import collectives as coll
from ..sharding.rules import current_ctx, rank_block, use_ctx
from .params import leaf_axes, pd


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


def mesh_blocks(params: dict, defs: dict):
    """(params, split): under a sharding context each leaf of the flat
    dict ``params`` as the rank's block of its def in ``defs`` (a whole
    leaf narrowed, ``ShardCtx.block``; a block of the def's block shape as
    it is; another shape raises), and ``split(name, dim)``, the
    ``ShardCtx.dim_block`` of that leaf's dim. Without a context the
    leaves as they are and every dim whole."""
    ctx = current_ctx()
    if ctx is None:
        return params, lambda name, dim: (0, defs[name].shape[dim], ())
    out = dict(params)
    for name, d in defs.items():
        if name not in params or not hasattr(d, "shape"):
            continue
        w, axes = params[name], leaf_axes(d)
        if tuple(w.shape) == d.shape and ctx.spec_for(d.shape, axes):
            out[name] = ctx.block(w, axes)
        elif tuple(w.shape) != ctx.block_shape(d.shape, axes):
            raise ValueError(f"{name} of shape {tuple(w.shape)}: neither "
                             f"the whole {d.shape} nor its block")
    return out, lambda name, dim: ctx.dim_block(
        defs[name].shape, leaf_axes(defs[name]), dim)


def tp_cols(y: torch.Tensor, block: tuple, lo: int, hi: int,
            dim: int = -1) -> torch.Tensor:
    """Columns [lo, hi) along ``dim`` of an activation of which ``y``
    holds the rank's block ``block`` = (start, size, axes) (a
    ``dim_block``): narrowed from ``y`` when the block covers them, else
    gathered whole over the axes first (a block that does not fall on a
    head's boundary)."""
    start, size, axes = block
    if axes and not (start <= lo and hi <= start + size):
        y = coll.gather_dim(y, axes, dim % y.dim())
        start = 0
    if lo - start == 0 and hi - lo == y.shape[dim]:
        return y
    return y.narrow(dim, lo - start, hi - lo)


def row_psum(y: torch.Tensor, axes: tuple) -> torch.Tensor:
    """A row-parallel product's partial sums added over ``axes`` (none:
    the product was whole)."""
    return coll.psum(y, axes) if axes else y


def mlp(params, x: torch.Tensor, act: str = "silu",
        ffn: int | None = None) -> torch.Tensor:
    """SwiGLU (``act="silu"``) or GeGLU with the tanh-approximate GELU.
    ``ffn``: the whole hidden width, which a sharding context splits over
    "ffn" (the module docstring; default: the weights' own)."""
    if current_ctx() is not None:
        ffn = ffn or params["down"].shape[0]
        params, split = mesh_blocks(params, mlp_defs(x.shape[-1], ffn,
                                                     "float32"))
        axes = split("down", 0)[2]
    else:
        axes = ()
    g = x @ params["gate"]
    u = x @ params["up"]
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return row_psum((a * u) @ params["down"], axes)


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


def vocab_block(vocab: int) -> tuple:
    """The ``dim_block`` of a vocabulary of ``vocab`` words over "vocab"
    under the current context: the rank's (start, size, axes)."""
    ctx = current_ctx()
    if ctx is None:
        return 0, vocab, ()
    return ctx.dim_block((vocab,), ("vocab",), 0)


def head_logits(params, h: torch.Tensor, final_cap: float = 0.0,
                tied: bool = False, vocab: int | None = None) -> torch.Tensor:
    """f32 logits ``h.float() @ W.float()``; with ``tied``, ``params`` is
    the embedding and ``W`` its transpose. ``vocab``: the whole
    vocabulary, which a sharding context splits over "vocab": the logits
    are then those of the rank's block of it (``vocab_block``), from the
    whole weight or its block."""
    w = params.get("w32")
    if w is None:
        w = params["w"].float()
        if tied:
            w = w.T
    if vocab is not None and current_ctx() is not None:
        _, _, axes = vocab_block(vocab)
        if axes:
            w = rank_block(w, 1, vocab, axes, current_ctx())
    return softcap(h.float() @ w, final_cap)


def chunked_xent(head_params, h: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None, *, final_cap: float = 0.0,
                 tied: bool = False, chunk: int = 2048,
                 remat_body: bool = False,
                 vocab: int | None = None) -> torch.Tensor:
    """h (B,S,d); labels (B,S) int; mean softmax cross-entropy over
    ``mask`` (all positions when None), an f32 scalar.

    The f32 logits of ``chunk`` positions at a time go through the head
    (``head_logits``: softcap, tied head), so the (tokens, vocab) logits
    never materialise at once; the token axis is zero-padded to a whole
    number of chunks with mask 0, as the reference pads. The head's f32
    weight is cast once and shared by every chunk. ``remat_body``
    checkpoints each chunk (``torch.utils.checkpoint``), so backward
    recomputes its logits instead of keeping every (chunk, vocab) block.

    ``vocab``: the whole vocabulary; a sharding context that splits it
    over "vocab" makes the loss vocab-parallel: each rank computes the
    logits of its block of words, the log-partition is the max over the
    ranks (``pmax``, held constant) plus the log of the exp sums summed
    over them (``psum``), and the label's logit comes from the rank whose
    block holds it (a masked gather summed over them)."""
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
    w = w.T if tied else w
    v0, v_loc, axes = vocab_block(vocab or w.shape[1])
    if axes:
        w = rank_block(w, 1, vocab, axes, current_ctx())
    head = {"w32": w}
    ctx = current_ctx()

    def body(hx, lx, mx):
        logits = head_logits(head, hx, final_cap)          # (chunk, V_loc)
        if not axes:
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, lx[:, None])[:, 0]
            return ((logz - gold) * mx).sum()
        # a chunk recomputed in backward runs on the autograd engine's
        # thread for CUDA tensors, where the mesh's context is not set
        with use_ctx(ctx):
            return vocab_parallel(logits, lx, mx)

    def vocab_parallel(logits, lx, mx):
        m = coll.pmax(logits.detach().amax(dim=-1), axes)
        logz = m + torch.log(coll.psum(
            torch.exp(logits - m[:, None]).sum(dim=-1), axes))
        rel = lx - v0
        own = (rel >= 0) & (rel < v_loc)
        gold = logits.gather(1, rel.clamp(0, v_loc - 1)[:, None])[:, 0]
        gold = coll.psum(torch.where(own, gold, 0.0), axes)
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
