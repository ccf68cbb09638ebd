"""GQA attention: prefill path and per-slot decode path over a KV cache
(PyTorch port of ``repro.models.attention``).

Prefill, the encoder and decode on the CPU are plain torch ops, mirroring
the reference's ``_sdpa``: f32 scores, masked entries set to ``NEG_INF =
-2**30`` (not ``-inf``, so a fully masked row softmaxes to uniform weights
instead of NaN), softmax, then the value product in the cache's dtype. A
prefill longer than ``chunk_threshold`` tokens takes ``_chunk_attn``:
flash-style two-level chunking with an online softmax in f32 that never
computes a KV block past the causal frontier, nor, on a sliding-window
(``local``) layer, one wholly before the window. An encoder
(``cfg.is_encoder``) attends without the causal mask. The reference has no
attention kernel of its own; these are the counterparts of the XLA ops it
uses.

Decode on any other device (the card; meta and fake tensors trace it) is
one call of K3, ``kernels.decode_attn`` (``repro_torch::decode_attention``):
it writes the new k and v rows into the caches and attends each row's
valid keys only (the keys the plain route's mask lets through; the others
weigh exp(NEG_INF - m) = 0 there), reading the caches in place in their
own dtype: f32 sums of the exact products of q and k, an f32 softmax and
value sum, the output rounded to the cache's dtype once. Both orders of
the score product (``bf16_scores`` or not) compute that same sum, so the
flag does not change the card's decode route, nor does
``decode_window_slice`` (the kernel reads only the window's keys). Decode
under ``kv_seq`` keeps the plain route on every device (below).

``bf16_scores`` (``RunFlags.attn_bf16_scores``) is the reference's
``preferred_element_type=f32`` score product: q and k stay in their own
dtype and the products are summed in f32 into f32 scores, without an f32
copy of the cache. torch has no ``preferred_element_type``, and a bf16
``einsum`` rounds its output to bf16. On the card the route is
``torch.bmm(a, b, out_dtype=torch.float32)`` (``aten::bmm.dtype``: bf16
operands, f32 accumulation and output; it raises where torch lacks it).
On the CPU, where ``aten::bmm.dtype`` has no kernel, the operands are
upcast to f32 first: a product of two bf16 numbers is exact in f32, so
this is the same sum, the plain route and not a fallback. The route is
picked from the operands' device.

Under a sharding context the layer runs on the rank's heads
(``_head_plan``): ``wq``/``wk``/``wv`` column-parallel over "heads" and
"kv_heads", ``wo`` row-parallel with a ``psum`` of the partial outputs.
The rank computes the query heads its block of ``wo``'s rows reads, and
keeps the KV heads of its block of the KV cache (the reference's state
layout: split over "kv_heads" where the axis divides the KV heads, else
whole). A projection whose block does not fall on a head's boundary (the
divisibility fallback splits the reference's ``hq * hd`` columns, not its
heads) is gathered whole first (``layers.tp_cols``); query heads that do
not start a KV group attend their KV heads expanded one per query head.

``kv_seq`` (the reference's flash-decode layout, a rule that maps the
logical axis to mesh axes) splits a KV leaf's sequence: a rank's cache
block holds ``max_len / n`` positions (``kv_split``, ``kv_seq_block``),
its KV heads resolved after the sequence as the reference's ``spec_for``
resolves a leaf's axes (whole when ``kv_seq`` takes their axis). Decode
then attends the rank's positions and combines the partial softmaxes in
GSPMD's two-pass order (``split_softmax``: the max, then the sums, then
the weighted values, each summed over the sequence's axes). Where the
sequence shares an axis with the query heads ("model"), every rank
computes every head (``HeadPlan`` over all heads, the projections
gathered whole) and keeps its rows of ``wo``. The reference resolves the
batch before ``kv_seq``, so the rule takes an axis only where the whole
batch does not fill it (``launch.dryrun.cell_rules`` sets it over "data"
just then); a rank's step sees its share of the batch, not the whole, so
the port takes ``kv_seq``'s axes as they resolve and leaves the batch
whole on them (``launch.dryrun.effective_rules`` cuts a rule to what a
cell's state resolves first).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ModelConfig
from ..kernels.decode_attn import decode_attention as k3_decode_attention
from ..sharding import collectives as coll
from ..sharding.rules import current_ctx
from .layers import (apply_rope, mesh_blocks, rmsnorm, row_psum, softcap,
                     tp_cols)
from .loops import trips
from .params import pd

NEG_INF = -2.0 ** 30


def attn_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": pd(d, hq * hd, axes=(None, "heads"), dtype=dtype, fan_in=fan_in),
        "wk": pd(d, hkv * hd, axes=(None, "kv_heads"),
                 dtype=dtype, fan_in=fan_in),
        "wv": pd(d, hkv * hd, axes=(None, "kv_heads"),
                 dtype=dtype, fan_in=fan_in),
        "wo": pd(hq * hd, d, axes=("heads", None), dtype=dtype, fan_in=fan_in),
    }
    if cfg.qk_norm:
        defs["q_norm"] = {"scale": pd(hd, init="ones")}
        defs["k_norm"] = {"scale": pd(hd, init="ones")}
    return defs


def _rope_theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "local" and cfg.rope_local_theta > 0:
        return cfg.rope_local_theta
    return cfg.rope_theta


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window_size if kind == "local" else 0


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """What a rank computes of an attention layer: query heads [h0, h1),
    the KV heads [k0, k1) they read, the KV heads [c0, c1) of its cache
    block, the ``dim_block`` of each projection's columns (``cols``) and
    of ``wo``'s rows (``rows``), and whether the query heads start KV
    groups (``grouped``). Without a context: every head, nothing split."""
    h0: int
    h1: int
    k0: int
    k1: int
    c0: int
    c1: int
    cols: dict
    rows: tuple
    grouped: bool


def head_range(rows: tuple, width: int, total: int) -> tuple:
    """[h0, h1): the heads of ``width`` features that a rank's block
    ``rows`` (a ``dim_block`` of ``total`` heads' features) touches."""
    start, size, axes = rows
    if not axes:
        return 0, total
    return start // width, -(-(start + size) // width)


# a KV leaf's logical axes (``launch.specs``' state layout for k and v)
KV_AXES = ("batch", "kv_seq", "kv_heads", None)


def kv_split(n_kv: int = 1) -> tuple:
    """(seq, c0, c1): the mesh axes a rank's cache block splits the
    sequence over (``kv_seq``'s; ``()`` without the rule or a context)
    and the KV heads [c0, c1) of its block, resolved after the sequence
    as ``spec_for`` resolves ``KV_AXES`` (split over "kv_heads" where the
    axis divides them and ``kv_seq`` did not take it). The batch takes
    none of ``kv_seq``'s axes (module docstring)."""
    ctx = current_ctx()
    if ctx is None:
        return (), 0, n_kv
    shape = (1, ctx.axis_prod(ctx.resolve("kv_seq")), n_kv, 1)
    seq = ctx.dim_block(shape, KV_AXES, 1)[2]
    start, size, _ = ctx.dim_block(shape, KV_AXES, 2)
    return seq, start, start + size


def kv_seq_block(max_len: int, seq: tuple) -> tuple:
    """(start, size): the positions of ``max_len`` a rank's cache block
    holds when the sequence is split over ``seq`` (``kv_split``)."""
    if not seq:
        return 0, max_len
    ctx = current_ctx()
    n = ctx.axis_prod(seq)
    if max_len % n:
        raise ValueError(f"kv_seq over {seq} ({n} ranks) does not divide "
                         f"max_len {max_len} (the reference drops the "
                         f"axis: take the rule off)")
    return seq_start(max_len // n, seq), max_len // n


def seq_start(size: int, seq: tuple) -> int:
    """The first position of a rank's ``kv_seq`` block of ``size``
    positions (0 when the sequence is whole)."""
    return current_ctx().mesh.index(seq) * size if seq else 0


def _head_plan(cfg: ModelConfig, split, seq: tuple = ()) -> HeadPlan:
    """The rank's ``HeadPlan``; every query head where the KV sequence is
    split over an axis the heads are split over (``seq``)."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hkv
    rows = split("wo", 0)
    h0, h1 = (0, hq) if set(rows[2]) & set(seq) else \
        head_range(rows, hd, hq)
    k0, k1 = h0 // g, -(-h1 // g)
    _, c0, c1 = kv_split(hkv)
    if not (c0 <= k0 and k1 <= c1):
        raise ValueError(f"query heads [{h0}, {h1}) read KV heads [{k0}, "
                         f"{k1}) outside the cache block [{c0}, {c1})")
    return HeadPlan(h0, h1, k0, k1, c0, c1,
                    {n: split(n, 1) for n in ("wq", "wk", "wv")}, rows,
                    h0 % g == 0 and h1 % g == 0)


def _qkv(cfg: ModelConfig, params, h, positions, kind: str, plan=None):
    """q, k, v of h (B, S, d): the qk-norms (when the config has them),
    then RoPE at the layer kind's base. positions (S,) or (B, S). With a
    ``plan`` (a sharding context; ``params`` the rank's blocks) q holds
    the plan's query heads and k, v its cache block's KV heads."""
    B, S, _ = h.shape
    hd = cfg.head_dim
    if plan is None:
        q = (h @ params["wq"]).reshape(B, S, cfg.n_heads, hd)
        k = (h @ params["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
        v = (h @ params["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    else:
        c = plan.cols
        q = tp_cols(h @ params["wq"], c["wq"], plan.h0 * hd, plan.h1 * hd)
        k = tp_cols(h @ params["wk"], c["wk"], plan.c0 * hd, plan.c1 * hd)
        v = tp_cols(h @ params["wv"], c["wv"], plan.c0 * hd, plan.c1 * hd)
        q, k, v = (t.reshape(B, S, -1, hd) for t in (q, k, v))
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    theta = _rope_theta(cfg, kind)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def _mask(qpos, kpos, *, causal: bool, window: int = 0):
    """(..., Q, K) boolean validity mask from position vectors; with
    ``window`` a key must also lie within ``window`` positions of the
    query (``kpos > qpos - window``)."""
    m = torch.ones(qpos.shape[:-1] + (qpos.shape[-1], kpos.shape[-1]),
                   dtype=torch.bool, device=qpos.device)
    if causal:
        m &= kpos[..., None, :] <= qpos[..., :, None]
    if window > 0:
        m &= kpos[..., None, :] > qpos[..., :, None] - window
    return m


def f32_bmm(a, b):
    """``a @ b`` over a batch, (N, M, K) x (N, K, P) -> f32 (N, M, P),
    summed in f32 from operands of any float dtype (see the module
    docstring for the two routes)."""
    if a.device.type == "cpu":
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


def split_softmax(scores, valid, seq: tuple, value):
    """The reference's softmax over keys split over the ranks of ``seq``
    (GSPMD's order, not the online softmax's rescaling): the rank's f32
    ``scores`` (..., K) masked by ``valid`` with ``NEG_INF``, the max
    over every rank's keys (``pmax``), ``p = exp(s - M)``, the sum over
    every rank's (``psum``), then ``value(p / L)`` (the rank's partial
    product with its values, summed in f32) summed over the ranks. A rank
    with no valid key weighs exp(NEG_INF - M) = 0 and adds nothing."""
    s = torch.where(valid, scores, NEG_INF)
    m = coll.pmax(s.amax(dim=-1, keepdim=True), seq)
    p = torch.exp(s - m)
    denom = coll.psum(p.sum(dim=-1, keepdim=True), seq)
    return coll.psum(value(p / denom), seq)


def _pv(p, v):
    """p (B,Hkv,g,Q,K) @ v (B,K,Hkv,D) -> (B,Q,Hkv,g,D), summed in f32."""
    if v.dtype == torch.float32:
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    B, hkv, g, Q, K = p.shape
    out = f32_bmm(p.reshape(B * hkv, g * Q, K),
                  v.permute(0, 2, 1, 3).reshape(B * hkv, K, v.shape[-1]))
    return out.view(B, hkv, g, Q, -1).permute(0, 3, 1, 2, 4)


def _sdpa(cfg: ModelConfig, q, k, v, mask, bf16_scores: bool = False,
          seq: tuple = ()):
    """Dense grouped attention. q: (B,Q,Hq,D) k/v: (B,K,Hkv,D), mask
    broadcastable to (B,Q,K). ``bf16_scores``: the score product from q
    and k in their own dtype, summed in f32 (``f32_bmm``). ``seq``: the
    keys are the rank's block of a sequence split over those mesh axes
    (``split_softmax``; the weights cast to the values' dtype where the
    reference casts them, the combined output too)."""
    B, Q, hq, hd = q.shape
    K, hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    qg = q.reshape(B, Q, hkv, g, hd)
    if bf16_scores:
        # (B*hkv, g*Q, D) @ (B*hkv, D, K): the einsum's own batching; the
        # permute copies K (the cache is laid out (B, S, Hkv, D))
        qb = qg.permute(0, 2, 3, 1, 4).reshape(B * hkv, g * Q, hd)
        kb = k.permute(0, 2, 3, 1).reshape(B * hkv, hd, K)
        scores = f32_bmm(qb, kb).view(B, hkv, g, Q, K) / math.sqrt(hd)
    else:
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                              k.float()) / math.sqrt(hd)
    scores = softcap(scores, cfg.attn_logit_softcap)
    while mask.ndim < scores.ndim:
        mask = mask[:, None]
    if seq:
        out = split_softmax(scores, mask, seq,
                            lambda p: _pv(p.to(v.dtype), v)).to(v.dtype)
        return out.reshape(B, Q, hq, hd_v)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Q, hq, hd_v)


def _chunk_attn(cfg: ModelConfig, q, k, v, qpos, kpos, *,
                causal: bool = True, window: int = 0, q_chunk: int = 1024,
                kv_chunk: int = 1024):
    """Attention in (q chunk, kv chunk) blocks with a running max and sum
    per query (the online softmax), all in f32. With ``causal`` KV blocks
    past a q chunk's causal frontier are skipped (without it the frontier
    is the last block, ``nk``), and with ``window`` so are the blocks
    below ``lo = max(0, (i*q_chunk - window) // kv_chunk)`` (the
    reference's static window frontier; the mask still applies inside the
    blocks computed). ``_chunk_attn.window_skipped`` counts the blocks the
    window skipped. Padded query positions are -1 (they are sliced off);
    padded key positions are 2**30: the causal mask excludes them, and
    without it a validity mask over the real keys does. (The reference's
    non-causal path lets them into the softmax, ROADMAP F12.)

    q, k and v are split into their blocks once (``torch.split``), so a
    backward assembles each one's gradient once, not a whole-size zero
    gradient per block pair.
    """
    B, S, hq, hd = q.shape
    hkv, hd_v = k.shape[2], v.shape[-1]
    g = hq // hkv
    nq = -(-S // q_chunk)
    nk = -(-S // kv_chunk)
    pad_q = nq * q_chunk - S
    pad_k = nk * kv_chunk - S
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        qpos = torch.cat([qpos, qpos.new_full((pad_q,), -1)])
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        kpos = torch.cat([kpos, kpos.new_full((pad_k,), 2 ** 30)])
    scale = 1.0 / math.sqrt(hd)
    q_blocks = torch.split(q, q_chunk, dim=1)
    k_blocks = torch.split(k, kv_chunk, dim=1)
    v_blocks = torch.split(v, kv_chunk, dim=1)
    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qi = q_blocks[i].reshape(B, q_chunk, hkv, g, hd).float()
        # the causal KV frontier of this q chunk, and the window's
        hi = min(nk, -(-((i + 1) * q_chunk) // kv_chunk)) if causal else nk
        lo = max(0, (i * q_chunk - window) // kv_chunk) if window > 0 else 0
        _chunk_attn.window_skipped += lo
        m_run = torch.full((B, hkv, g, q_chunk), NEG_INF, device=q.device)
        l_run = torch.zeros((B, hkv, g, q_chunk), device=q.device)
        acc = torch.zeros((B, hkv, g, q_chunk, hd_v), device=q.device)
        for j in trips(lo, hi, q):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi,
                             k_blocks[j].float()) * scale
            s = softcap(s, cfg.attn_logit_softcap)
            valid = _mask(qpos[qs], kpos[ks], causal=causal, window=window)
            if not causal:
                valid &= kpos[ks] < 2 ** 30          # the pad keys
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_blocks[j].float())
            m_run = m_new
        out_i = acc / l_run[..., None].clamp(min=1e-20)
        outs.append(out_i.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, hq,
                                                         hd_v))
    return torch.cat(outs, dim=1)[:, :S].to(q.dtype)


_chunk_attn.window_skipped = 0


def mesh_layer(cfg: ModelConfig, params, seq: tuple = ()):
    """(params, plan): under a sharding context the rank's blocks of the
    layer's weights and its ``HeadPlan`` (``seq``: the axes decode's KV
    sequence is split over); without one (params, None)."""
    if current_ctx() is None:
        return params, None
    params, split = mesh_blocks(params, attn_defs(cfg, "float32"))
    return params, _head_plan(cfg, split, seq)


def kv_for_queries(plan, g: int, k, v):
    """The KV heads the plan's query heads read, of k/v (B, S, Hkv, D)
    holding its cache block's heads; expanded one per query head (group
    size 1) when the query heads do not start KV groups of ``g``."""
    if plan is None:
        return k, v
    k = k[:, :, plan.k0 - plan.c0:plan.k1 - plan.c0]
    v = v[:, :, plan.k0 - plan.c0:plan.k1 - plan.c0]
    if not plan.grouped:
        idx = torch.arange(plan.h0, plan.h1, device=k.device) // g - plan.k0
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return k, v


def out_proj(wo, out, width: int, rows=None, h0: int = 0):
    """``out`` (B, S, heads, width), heads from ``h0``, through ``wo``:
    with ``rows`` (the ``dim_block`` of ``wo``'s rows a rank holds) the
    columns of that block, and the partial products summed over its axes
    (row-parallel)."""
    out = out.reshape(*out.shape[:2], -1)
    if rows is None:
        return out @ wo
    start, size, axes = rows
    return row_psum(out.narrow(-1, start - h0 * width, size) @ wo, axes)


def _out(plan, wo, out, width: int):
    return out_proj(wo, out, width) if plan is None else \
        out_proj(wo, out, width, plan.rows, plan.h0)


def attention(cfg: ModelConfig, params, h, positions, kind: str = "global",
              *, q_chunk: int = 1024, kv_chunk: int = 1024,
              chunk_threshold: int = 2048, bf16_scores: bool = False):
    """Prefill (or encoder) attention. h (B,S,d), positions (S,). Returns
    (out, kv). ``local`` layers attend within ``cfg.window_size``; an
    encoder attends every position. More than ``chunk_threshold`` tokens
    take ``_chunk_attn`` (f32 scores either way, as in the reference).
    Under a sharding context the rank's heads (module docstring); kv holds
    its cache block's KV heads."""
    params, plan = mesh_layer(cfg, params)
    q, k, v = _qkv(cfg, params, h, positions, kind, plan)
    ka, va = kv_for_queries(plan, cfg.n_heads // cfg.n_kv_heads, k, v)
    causal = not cfg.is_encoder
    window = _window(cfg, kind)
    if h.shape[1] <= chunk_threshold:
        mask = _mask(positions, positions, causal=causal,
                     window=window)[None]
        out = _sdpa(cfg, q, ka, va, mask, bf16_scores)
    else:
        out = _chunk_attn(cfg, q, ka, va, positions, positions,
                          causal=causal, window=window, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    return _out(plan, params["wo"], out, cfg.head_dim), {"k": k, "v": v}


def write_rows(cache, new, positions, seq: tuple = ()):
    """Write ``new`` (B, ...) into ``cache`` (B, S, ...) in place, row b at
    position ``positions[b]``, clamped to the last position (the
    reference's dynamic_update_slice clamps). With ``seq`` the cache is
    the rank's ``kv_seq`` block of n * S positions: only the block that
    holds the clamped position takes the row, the others write back what
    they hold. Device indices, no sync."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    new = new.to(cache.dtype)
    if not seq:
        cache[rows, positions.clamp(0, S - 1)] = new
        return
    at = positions.clamp(0, current_ctx().axis_prod(seq) * S - 1) - \
        seq_start(S, seq)
    own = ((at >= 0) & (at < S)).view((B,) + (1,) * (new.dim() - 1))
    at = at.clamp(0, S - 1)
    cache[rows, at] = torch.where(own, new, cache[rows, at])


def decode_attention(cfg: ModelConfig, params, h, cache, positions,
                     kind: str = "global", *, bf16_scores: bool = False,
                     window_slice: bool = False):
    """Single-token decode. h (B,1,d); cache {k,v}: (B,Smax,Hkv,D), under
    a sharding context the rank's block (its KV heads, and under
    ``kv_seq`` its positions: the module docstring); positions (B,)
    current index per sequence. Returns (out, cache).

    The new k/v rows are written INTO ``cache`` at each row's position,
    clamped into the cache: an in-place scatter instead of the reference's
    functional copy of the whole cache per layer per step.

    On the card (any device but the CPU, without ``kv_seq``) the write and
    the attention are one launch of K3 (``kernels.decode_attn``): row b
    attends keys ``max(0, pos_b - window + 1) .. min(pos_b, Smax - 1)``
    (from 0 on a global layer), the keys the plain route's mask lets
    through, every key with equal weight where it lets none through, as
    the plain route's softmax over ``NEG_INF`` does. Under a sharding
    context the kernel reads the cache block's KV heads in place, query
    head i of the plan reading KV head ``(h0 + i) // g - c0``, the heads
    ``kv_for_queries`` gives the plain route. ``bf16_scores`` and
    ``window_slice`` do not change this route (module docstring). On the
    CPU, and under ``kv_seq``, ``plain_decode``."""
    seq = kv_split()[0]
    params, plan = mesh_layer(cfg, params, seq)
    q, k, v = _qkv(cfg, params, h, positions[:, None], kind, plan)
    kc, vc = cache["k"], cache["v"]
    window = _window(cfg, kind)
    if kc.device.type != "cpu" and not seq:
        g = cfg.n_heads // cfg.n_kv_heads
        out = k3_decode_attention(
            q[:, 0], k[:, 0], v[:, 0], kc, vc, positions, window=window,
            softcap=cfg.attn_logit_softcap, group=g,
            q_offset=0 if plan is None else plan.h0 - plan.c0 * g)[:, None]
    else:
        out = plain_decode(cfg, q, k, v, kc, vc, positions, window,
                           plan=plan, seq=seq, bf16_scores=bf16_scores,
                           window_slice=window_slice)
    return _out(plan, params["wo"], out, cfg.head_dim), cache


def plain_decode(cfg: ModelConfig, q, k, v, kc, vc, positions, window: int,
                 *, plan=None, seq: tuple = (), bf16_scores: bool = False,
                 window_slice: bool = False):
    """``decode_attention``'s plain route from its projections, q (B,1,Hq,D)
    and the new k, v (B,1,Hkv,D): ``write_rows`` into kc, vc, the key
    positions' mask and ``_sdpa``; out (B,1,Hq,D). ``window_slice``: a
    ``local`` layer attends a gathered window-sized slice of the cache
    (rows ``start .. start + w - 1``, ``start`` clamped into the cache)
    instead of masking the whole context; the gather's indices stay on the
    device. Under ``kv_seq`` it takes the masked route over the rank's
    block (the same keys valid, the masked ones weighing 0).
    ``bf16_scores``: see ``_sdpa``."""
    B, S = kc.shape[:2]
    write_rows(kc, k[:, 0], positions, seq)
    write_rows(vc, v[:, 0], positions, seq)
    if window_slice and 0 < window < S and not seq:
        rows = torch.arange(B, device=kc.device)
        start = (positions - (window - 1)).clamp(0, S - window)
        kpos = start[:, None] + torch.arange(window, device=kc.device)
        k_att, v_att = kc[rows[:, None], kpos], vc[rows[:, None], kpos]
        valid = kpos <= positions[:, None]         # window via the slice
    else:
        k_att, v_att = kc, vc
        kpos = seq_start(S, seq) + torch.arange(S, device=kc.device)[None]
        valid = kpos <= positions[:, None]
        if window > 0:
            valid &= kpos > positions[:, None] - window
    k_att, v_att = kv_for_queries(plan, cfg.n_heads // cfg.n_kv_heads,
                                  k_att, v_att)
    return _sdpa(cfg, q, k_att, v_att, valid[:, None, :], bf16_scores, seq)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    """Zero k/v caches (batch, max_len, Hkv, D): under a sharding context
    the rank's block (``kv_split``: its KV heads, and under ``kv_seq`` its
    ``max_len / n`` positions)."""
    seq, c0, c1 = kv_split(cfg.n_kv_heads)
    shape = (batch, kv_seq_block(max_len, seq)[1], c1 - c0, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
