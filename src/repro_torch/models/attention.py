"""GQA attention: prefill path and per-slot decode path over a KV cache
(PyTorch port of ``repro.models.attention``).

Plain torch ops only, mirroring the reference's ``_sdpa``: f32 scores,
masked entries set to ``NEG_INF = -2**30`` (not ``-inf``, so a fully masked
row softmaxes to uniform weights instead of NaN), softmax, then the value
product in the cache's dtype. A prefill longer than ``chunk_threshold``
tokens takes ``_chunk_attn``: flash-style two-level chunking with an
online softmax in f32 that never computes a KV block past the causal
frontier, nor, on a sliding-window (``local``) layer, one wholly before
the window. An encoder (``cfg.is_encoder``) attends without the causal
mask. The reference has no attention kernel of its own; these are the
counterparts of the XLA ops it uses.

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
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
import dataclasses

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


def cache_heads(n_kv: int) -> tuple:
    """[c0, c1): the KV heads of a rank's cache block, the reference's
    state layout (split over "kv_heads" where it divides them)."""
    ctx = current_ctx()
    if ctx is None:
        return 0, n_kv
    start, size, _ = ctx.dim_block((n_kv,), ("kv_heads",), 0)
    return start, start + size


def _head_plan(cfg: ModelConfig, split) -> HeadPlan:
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hkv
    rows = split("wo", 0)
    h0, h1 = head_range(rows, hd, hq)
    k0, k1 = h0 // g, -(-h1 // g)
    c0, c1 = cache_heads(hkv)
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


def _sdpa(cfg: ModelConfig, q, k, v, mask, bf16_scores: bool = False):
    """Dense grouped attention. q: (B,Q,Hq,D) k/v: (B,K,Hkv,D), mask
    broadcastable to (B,Q,K). ``bf16_scores``: the score product from q
    and k in their own dtype, summed in f32 (``f32_bmm``)."""
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
    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qi = q[:, qs].reshape(B, q_chunk, hkv, g, hd).float()
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
                             k[:, ks].float()) * scale
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
                "bhgqk,bkhd->bhgqd", p, v[:, ks].float())
            m_run = m_new
        out_i = acc / l_run[..., None].clamp(min=1e-20)
        outs.append(out_i.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, hq,
                                                         hd_v))
    return torch.cat(outs, dim=1)[:, :S].to(q.dtype)


_chunk_attn.window_skipped = 0


def mesh_layer(cfg: ModelConfig, params):
    """(params, plan): under a sharding context the rank's blocks of the
    layer's weights and its ``HeadPlan``; without one (params, None)."""
    if current_ctx() is None:
        return params, None
    params, split = mesh_blocks(params, attn_defs(cfg, "float32"))
    return params, _head_plan(cfg, split)


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


def decode_attention(cfg: ModelConfig, params, h, cache, positions,
                     kind: str = "global", *, bf16_scores: bool = False,
                     window_slice: bool = False):
    """Single-token decode. h (B,1,d); cache {k,v}: (B,Smax,Hkv,D), under
    a sharding context the rank's block of the KV heads; positions (B,)
    current index per sequence. Returns (out, cache).

    The new k/v rows are written INTO ``cache`` at each row's position
    (clamped to the last row, as the reference's dynamic_update_slice
    clamps): an in-place scatter instead of the reference's functional copy
    of the whole cache per layer per step.

    ``window_slice``: a ``local`` layer attends a gathered window-sized
    slice of the cache (rows ``start .. start + w - 1``, ``start`` clamped
    into the cache) instead of masking the whole context; the gather's
    indices stay on the device. ``bf16_scores``: see ``_sdpa``."""
    B = h.shape[0]
    params, plan = mesh_layer(cfg, params)
    q, k, v = _qkv(cfg, params, h, positions[:, None], kind, plan)

    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    rows = torch.arange(B, device=h.device)
    at = positions.clamp(0, S - 1)
    kc[rows, at] = k[:, 0].to(kc.dtype)
    vc[rows, at] = v[:, 0].to(vc.dtype)

    window = _window(cfg, kind)
    if window_slice and 0 < window < S:
        start = (positions - (window - 1)).clamp(0, S - window)
        kpos = start[:, None] + torch.arange(window, device=h.device)
        k_att, v_att = kc[rows[:, None], kpos], vc[rows[:, None], kpos]
        valid = kpos <= positions[:, None]         # window via the slice
    else:
        k_att, v_att = kc, vc
        kpos = torch.arange(S, device=h.device)[None]       # (1, S)
        valid = kpos <= positions[:, None]
        if window > 0:
            valid &= kpos > positions[:, None] - window
    k_att, v_att = kv_for_queries(plan, cfg.n_heads // cfg.n_kv_heads,
                                  k_att, v_att)
    out = _sdpa(cfg, q, k_att, v_att, valid[:, None, :], bf16_scores)
    return _out(plan, params["wo"], out, cfg.head_dim), cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    """Zero k/v caches (batch, max_len, Hkv, D): under a sharding context
    the rank's block of the KV heads (``cache_heads``)."""
    c0, c1 = cache_heads(cfg.n_kv_heads)
    shape = (batch, max_len, c1 - c0, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
