"""DeepSeek Multi-head Latent Attention, v2/v3 (PyTorch port of
``repro.models.mla``).

Prefill decompresses per-head keys (``qk_nope + qk_rope`` wide: 192 at
deepseek-v2) and values (``v_head_dim``: 128) from the latent and runs the
GQA path's ``_sdpa``, or ``_chunk_attn`` above ``chunk_threshold``; both
take the score scale from the query's width, 1/sqrt(192). Decode is the
*absorbed* path: the cache holds only ``c_kv`` (kv_lora) and ``k_rope``
(rope) per token, ``W_uk`` is folded into the query and ``W_uv`` into the
output, and the scores are f32 over the latent cache, masked with
``NEG_INF``. RoPE is the half-split form on the rope dimensions only.
With ``bf16_scores`` both paths take the reference's
``preferred_element_type=f32`` products (``attention.f32_bmm``): decode
reads the latent cache in its own dtype, for the scores and for the
latent output, where the f32 path reads an f32 copy of it.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from .attention import NEG_INF, _chunk_attn, _mask, _sdpa, f32_bmm
from .layers import apply_rope, rmsnorm
from .params import pd


def mla_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": pd(d, m.q_lora_rank, dtype=dtype, fan_in=fan_in),
        "q_ln": {"scale": pd(m.q_lora_rank, init="ones")},
        "wuq": pd(m.q_lora_rank, H * qk_head, dtype=dtype, fan_in=fan_in),
        "wdkv": pd(d, m.kv_lora_rank + m.qk_rope_head_dim, dtype=dtype,
                   fan_in=fan_in),
        "kv_ln": {"scale": pd(m.kv_lora_rank, init="ones")},
        "wuk": pd(m.kv_lora_rank, H * m.qk_nope_head_dim, dtype=dtype,
                  fan_in=fan_in),
        "wuv": pd(m.kv_lora_rank, H * m.v_head_dim, dtype=dtype,
                  fan_in=fan_in),
        "wo": pd(H * m.v_head_dim, d, dtype=dtype, fan_in=fan_in),
    }


def _latents(cfg: ModelConfig, params, h, positions):
    """Shared by prefill and decode: the query heads' nope and rope parts
    and the compressed latents. h (B,S,d), positions (S,) or (B,S).
    Returns q_nope (B,S,H,nope), q_rope (B,S,H,rope), c_kv (B,S,kv_lora),
    k_rope (B,S,1,rope)."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = h.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    cq = rmsnorm(params["q_ln"], h @ params["wdq"], cfg.norm_eps)
    q = (cq @ params["wuq"]).reshape(B, S, H, nope + rope)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv_full = h @ params["wdkv"]
    c_kv = rmsnorm(params["kv_ln"], ckv_full[..., :m.kv_lora_rank],
                   cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., m.kv_lora_rank:][:, :, None, :],
                        positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(cfg: ModelConfig, params, h, positions,
                  kind: str = "global", *, q_chunk: int = 1024,
                  kv_chunk: int = 1024, chunk_threshold: int = 2048,
                  bf16_scores: bool = False):
    """Prefill. h (B,S,d), positions (S,). Returns (out, {c_kv, k_rope})."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = h.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _latents(cfg, params, h, positions)
    k_nope = (c_kv @ params["wuk"]).reshape(B, S, H, nope)
    v = (c_kv @ params["wuv"]).reshape(B, S, H, m.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rope)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    if S <= chunk_threshold:
        mask = _mask(positions, positions, causal=True)[None]
        out = _sdpa(cfg, q, k, v, mask, bf16_scores)
    else:
        out = _chunk_attn(cfg, q, k, v, positions, positions,
                          q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = out.reshape(B, S, H * m.v_head_dim) @ params["wo"]
    return out, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0]}


def mla_decode(cfg: ModelConfig, params, h, cache, positions, *,
               bf16_scores: bool = False):
    """Absorbed single-token decode. h (B,1,d); cache c_kv (B,Smax,kv_lora)
    and k_rope (B,Smax,rope); positions (B,). The new latent rows are
    written INTO the cache at each row's position, clamped to the last row
    (the reference's dynamic_update_slice clamps), with device indices.
    Returns (out, cache)."""
    m, H = cfg.mla, cfg.n_heads
    B = h.shape[0]
    nope, rope, R = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    q_nope, q_rope, c_new, kr_new = _latents(cfg, params, h,
                                             positions[:, None])
    # W_uk absorbed into the query: q_lat[h] = q_nope[h] @ W_uk[h].T
    wuk = params["wuk"].reshape(R, H, nope)
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope, wuk)     # (B,1,H,R)

    ckv, krp = cache["c_kv"], cache["k_rope"]
    S = ckv.shape[1]
    rows = torch.arange(B, device=h.device)
    at = positions.clamp(0, S - 1)
    ckv[rows, at] = c_new[:, 0].to(ckv.dtype)
    krp[rows, at] = kr_new[:, 0, 0].to(krp.dtype)

    if bf16_scores:
        # batch B: (H, R) @ (R, S) over the cache's own strides
        s_lat = f32_bmm(q_lat[:, 0], ckv.transpose(1, 2))[:, :, None]
        s_rope = f32_bmm(q_rope[:, 0], krp.transpose(1, 2))[:, :, None]
    else:
        ckv32 = ckv.float()
        s_lat = torch.einsum("bshl,bSl->bhsS", q_lat.float(), ckv32)
        s_rope = torch.einsum("bshr,bSr->bhsS", q_rope.float(), krp.float())
    scores = (s_lat + s_rope) * (1.0 / math.sqrt(nope + rope))
    valid = torch.arange(S, device=h.device)[None] <= positions[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if bf16_scores:
        out_lat = f32_bmm(p[:, :, 0].to(ckv.dtype), ckv)[:, None]
    else:
        out_lat = torch.einsum("bhsS,bSl->bshl", p, ckv32)
    wuv = params["wuv"].reshape(R, H, m.v_head_dim)
    out = torch.einsum("bshl,lhv->bshv", out_lat.to(h.dtype), wuv)
    out = out.reshape(B, 1, H * m.v_head_dim) @ params["wo"]
    return out, cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
