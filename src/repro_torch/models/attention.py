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
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from .layers import apply_rope, rmsnorm, softcap
from .params import pd

NEG_INF = -2.0 ** 30


def attn_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": pd(d, hq * hd, dtype=dtype, fan_in=fan_in),
        "wk": pd(d, hkv * hd, dtype=dtype, fan_in=fan_in),
        "wv": pd(d, hkv * hd, dtype=dtype, fan_in=fan_in),
        "wo": pd(hq * hd, d, dtype=dtype, fan_in=fan_in),
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


def _qkv(cfg: ModelConfig, params, h, positions, kind: str):
    """q, k, v of h (B, S, d): the qk-norms (when the config has them),
    then RoPE at the layer kind's base. positions (S,) or (B, S)."""
    B, S, _ = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ params["wq"]).reshape(B, S, hq, hd)
    k = (h @ params["wk"]).reshape(B, S, hkv, hd)
    v = (h @ params["wv"]).reshape(B, S, hkv, hd)
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
        for j in range(lo, hi):
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


def attention(cfg: ModelConfig, params, h, positions, kind: str = "global",
              *, q_chunk: int = 1024, kv_chunk: int = 1024,
              chunk_threshold: int = 2048, bf16_scores: bool = False):
    """Prefill (or encoder) attention. h (B,S,d), positions (S,). Returns
    (out, kv). ``local`` layers attend within ``cfg.window_size``; an
    encoder attends every position. More than ``chunk_threshold`` tokens
    take ``_chunk_attn`` (f32 scores either way, as in the reference)."""
    B, S, _ = h.shape
    q, k, v = _qkv(cfg, params, h, positions, kind)
    causal = not cfg.is_encoder
    window = _window(cfg, kind)
    if S <= chunk_threshold:
        mask = _mask(positions, positions, causal=causal,
                     window=window)[None]
        out = _sdpa(cfg, q, k, v, mask, bf16_scores)
    else:
        out = _chunk_attn(cfg, q, k, v, positions, positions, causal=causal,
                          window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"], {"k": k, "v": v}


def decode_attention(cfg: ModelConfig, params, h, cache, positions,
                     kind: str = "global", *, bf16_scores: bool = False,
                     window_slice: bool = False):
    """Single-token decode. h (B,1,d); cache {k,v}: (B,Smax,Hkv,D);
    positions (B,) current index per sequence. Returns (out, cache).

    The new k/v rows are written INTO ``cache`` at each row's position
    (clamped to the last row, as the reference's dynamic_update_slice
    clamps): an in-place scatter instead of the reference's functional copy
    of the whole cache per layer per step.

    ``window_slice``: a ``local`` layer attends a gathered window-sized
    slice of the cache (rows ``start .. start + w - 1``, ``start`` clamped
    into the cache) instead of masking the whole context; the gather's
    indices stay on the device. ``bf16_scores``: see ``_sdpa``."""
    B = h.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(cfg, params, h, positions[:, None], kind)

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
    out = _sdpa(cfg, q, k_att, v_att, valid[:, None, :], bf16_scores)
    out = out.reshape(B, 1, hq * hd)
    return out @ params["wo"], cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
