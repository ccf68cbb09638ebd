"""GQA attention: prefill path and per-slot decode path over a KV cache
(PyTorch port of ``repro.models.attention``).

Plain torch ops only, mirroring the reference's ``_sdpa``: f32 scores,
masked entries set to ``NEG_INF = -2**30`` (not ``-inf``, so a fully masked
row softmaxes to uniform weights instead of NaN), softmax, then the value
product in the cache's dtype. The reference has no attention kernel of its
own; these are the counterparts of the XLA ops it uses.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from .layers import apply_rope, softcap
from .params import pd

NEG_INF = -2.0 ** 30


def attn_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": pd(d, hq * hd, dtype=dtype, fan_in=fan_in),
        "wk": pd(d, hkv * hd, dtype=dtype, fan_in=fan_in),
        "wv": pd(d, hkv * hd, dtype=dtype, fan_in=fan_in),
        "wo": pd(hq * hd, d, dtype=dtype, fan_in=fan_in),
    }


def _qkv(cfg: ModelConfig, params, h, positions):
    B, S, _ = h.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ params["wq"]).reshape(B, S, hq, hd)
    k = (h @ params["wk"]).reshape(B, S, hkv, hd)
    v = (h @ params["wv"]).reshape(B, S, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(qpos, kpos, *, causal: bool):
    """(..., Q, K) boolean validity mask from position vectors."""
    m = torch.ones(qpos.shape[:-1] + (qpos.shape[-1], kpos.shape[-1]),
                   dtype=torch.bool, device=qpos.device)
    if causal:
        m &= kpos[..., None, :] <= qpos[..., :, None]
    return m


def _sdpa(cfg: ModelConfig, q, k, v, mask):
    """Dense grouped attention. q: (B,Q,Hq,D) k/v: (B,K,Hkv,D), mask
    broadcastable to (B,Q,K)."""
    B, Q, hq, hd = q.shape
    hkv, hd_v = k.shape[2], v.shape[-1]
    g = hq // hkv
    qg = q.reshape(B, Q, hkv, g, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(hd)
    scores = softcap(scores, cfg.attn_logit_softcap)
    while mask.ndim < scores.ndim:
        mask = mask[:, None]
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Q, hq, hd_v)


def attention(cfg: ModelConfig, params, h, positions, *,
              chunk_threshold: int = 2048):
    """Prefill attention. h (B,S,d), positions (S,). Returns (out, kv)."""
    B, S, _ = h.shape
    if S > chunk_threshold:
        raise NotImplementedError(
            f"prefill of {S} > chunk_threshold={chunk_threshold} tokens needs "
            "the chunked attention path (ROADMAP queue 1, item 1: _chunk_attn)")
    q, k, v = _qkv(cfg, params, h, positions)
    mask = _mask(positions, positions, causal=True)[None]
    out = _sdpa(cfg, q, k, v, mask)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ params["wo"], {"k": k, "v": v}


def decode_attention(cfg: ModelConfig, params, h, cache, positions):
    """Single-token decode. h (B,1,d); cache {k,v}: (B,Smax,Hkv,D);
    positions (B,) current index per sequence. Returns (out, cache).

    The new k/v rows are written INTO ``cache`` at each row's position
    (clamped to the last row, as the reference's dynamic_update_slice
    clamps): an in-place scatter instead of the reference's functional copy
    of the whole cache per layer per step."""
    B = h.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ params["wq"]).reshape(B, 1, hq, hd)
    k = (h @ params["wk"]).reshape(B, 1, hkv, hd)
    v = (h @ params["wv"]).reshape(B, 1, hkv, hd)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)

    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    rows = torch.arange(B, device=h.device)
    at = positions.clamp(0, S - 1)
    kc[rows, at] = k[:, 0].to(kc.dtype)
    vc[rows, at] = v[:, 0].to(vc.dtype)

    kpos = torch.arange(S, device=h.device)[None]          # (1, S)
    valid = kpos <= positions[:, None]
    out = _sdpa(cfg, q, kc, vc, valid[:, None, :])
    out = out.reshape(B, 1, hq * hd)
    return out @ params["wo"], cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
