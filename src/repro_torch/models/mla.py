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

Under a sharding context the layer runs on the rank's heads, as GQA's
does (``attention.out_proj``, ``layers.tp_cols``): ``wuq``, ``wuk`` and
``wuv`` are column-parallel over "heads" and ``wo`` row-parallel with a
``psum``; the latents (``wdq``, ``wdkv`` and their norms) have no heads
axis and are whole on every rank, and so are the latent caches but for
``kv_seq``: the reference's flash-decode rule splits their sequence
(``attention.kv_split``), and decode attends the rank's positions,
combined by ``attention.split_softmax``, every head on every rank where
the sequence takes the heads' axis.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from ..sharding.rules import current_ctx
from .attention import (NEG_INF, _chunk_attn, _mask, _sdpa, f32_bmm,
                        head_range, kv_seq_block, kv_split, out_proj,
                        seq_start, split_softmax, write_rows)
from .layers import apply_rope, mesh_blocks, rmsnorm, tp_cols
from .params import pd


def mla_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": pd(d, m.q_lora_rank, axes=(None, "lora"),
                  dtype=dtype, fan_in=fan_in),
        "q_ln": {"scale": pd(m.q_lora_rank, init="ones")},
        "wuq": pd(m.q_lora_rank, H * qk_head, axes=(None, "heads"),
                   dtype=dtype, fan_in=fan_in),
        "wdkv": pd(d, m.kv_lora_rank + m.qk_rope_head_dim,
                   axes=(None, "lora"), dtype=dtype,
                   fan_in=fan_in),
        "kv_ln": {"scale": pd(m.kv_lora_rank, init="ones")},
        "wuk": pd(m.kv_lora_rank, H * m.qk_nope_head_dim,
                  axes=(None, "heads"), dtype=dtype,
                  fan_in=fan_in),
        "wuv": pd(m.kv_lora_rank, H * m.v_head_dim,
                  axes=(None, "heads"), dtype=dtype,
                  fan_in=fan_in),
        "wo": pd(H * m.v_head_dim, d, axes=("heads", None),
                 dtype=dtype, fan_in=fan_in),
    }


def _mesh_layer(cfg: ModelConfig, params, seq: tuple = ()):
    """(params, heads, out): under a sharding context the rank's blocks, a
    function giving a head-split leaf's columns of the query heads the
    rank's block of ``wo``'s rows reads (every head where decode's latent
    sequence is split over the heads' axis, ``seq``), and the output
    projection over those heads (``attention.out_proj``, row-parallel);
    without one the leaves as they are and the plain projection."""
    m = cfg.mla
    if current_ctx() is None:
        return (params, lambda t, name, width: t,
                lambda wo, out: out_proj(wo, out, m.v_head_dim))
    params, split = mesh_blocks(params, mla_defs(cfg, "float32"))
    rows = split("wo", 0)
    h0, h1 = (0, cfg.n_heads) if set(rows[2]) & set(seq) else \
        head_range(rows, m.v_head_dim, cfg.n_heads)

    def heads(t, name, width):
        return tp_cols(t, split(name, 1), h0 * width, h1 * width)
    return params, heads, lambda wo, out: out_proj(wo, out, m.v_head_dim,
                                                   rows, h0)


def _latents(cfg: ModelConfig, params, h, positions,
             heads=lambda t, name, width: t):
    """Shared by prefill and decode: the query heads' nope and rope parts
    and the compressed latents. h (B,S,d), positions (S,) or (B,S).
    Returns q_nope (B,S,H,nope), q_rope (B,S,H,rope), c_kv (B,S,kv_lora),
    k_rope (B,S,1,rope); ``heads`` (``_mesh_layer``'s) gives the rank's
    query heads."""
    m = cfg.mla
    B, S, _ = h.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    cq = rmsnorm(params["q_ln"], h @ params["wdq"], cfg.norm_eps)
    q = heads(cq @ params["wuq"], "wuq", nope + rope).reshape(
        B, S, -1, nope + rope)
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
    m = cfg.mla
    B, S, _ = h.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    params, heads, project = _mesh_layer(cfg, params)
    q_nope, q_rope, c_kv, k_rope = _latents(cfg, params, h, positions,
                                            heads)
    H = q_nope.shape[2]
    k_nope = heads(c_kv @ params["wuk"], "wuk", nope).reshape(B, S, H, nope)
    v = heads(c_kv @ params["wuv"], "wuv", m.v_head_dim).reshape(
        B, S, H, m.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, rope)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    if S <= chunk_threshold:
        mask = _mask(positions, positions, causal=True)[None]
        out = _sdpa(cfg, q, k, v, mask, bf16_scores)
    else:
        out = _chunk_attn(cfg, q, k, v, positions, positions,
                          q_chunk=q_chunk, kv_chunk=kv_chunk)
    return project(params["wo"], out), {"c_kv": c_kv,
                                        "k_rope": k_rope[:, :, 0]}


def mla_decode(cfg: ModelConfig, params, h, cache, positions, *,
               bf16_scores: bool = False):
    """Absorbed single-token decode. h (B,1,d); cache c_kv (B,Smax,kv_lora)
    and k_rope (B,Smax,rope), under ``kv_seq`` the rank's block of the
    positions; positions (B,). The new latent rows are written INTO the
    cache at each row's position (``attention.write_rows``). Returns
    (out, cache)."""
    m = cfg.mla
    nope, rope, R = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    seq = kv_split()[0]
    params, heads, project = _mesh_layer(cfg, params, seq)
    q_nope, q_rope, c_new, kr_new = _latents(cfg, params, h,
                                             positions[:, None], heads)
    H = q_nope.shape[2]
    # W_uk absorbed into the query: q_lat[h] = q_nope[h] @ W_uk[h].T
    wuk = heads(params["wuk"], "wuk", nope).reshape(R, H, nope)
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope, wuk)     # (B,1,H,R)

    ckv, krp = cache["c_kv"], cache["k_rope"]
    S = ckv.shape[1]
    write_rows(ckv, c_new[:, 0], positions, seq)
    write_rows(krp, kr_new[:, 0, 0], positions, seq)

    if bf16_scores:
        # batch B: (H, R) @ (R, S) over the cache's own strides
        s_lat = f32_bmm(q_lat[:, 0], ckv.transpose(1, 2))[:, :, None]
        s_rope = f32_bmm(q_rope[:, 0], krp.transpose(1, 2))[:, :, None]
    else:
        ckv32 = ckv.float()
        s_lat = torch.einsum("bshl,bSl->bhsS", q_lat.float(), ckv32)
        s_rope = torch.einsum("bshr,bSr->bhsS", q_rope.float(), krp.float())
    scores = (s_lat + s_rope) * (1.0 / math.sqrt(nope + rope))
    kpos = seq_start(S, seq) + torch.arange(S, device=h.device)
    valid = (kpos[None] <= positions[:, None])[:, None, None, :]

    def value(p):
        if bf16_scores:
            return f32_bmm(p[:, :, 0].to(ckv.dtype), ckv)[:, None]
        return torch.einsum("bhsS,bSl->bshl", p, ckv32)
    if seq:
        out_lat = split_softmax(scores, valid, seq, value)
    else:
        out_lat = value(torch.softmax(torch.where(valid, scores, NEG_INF),
                                      dim=-1))
    wuv = heads(params["wuv"], "wuv", m.v_head_dim).reshape(
        R, H, m.v_head_dim)
    out = torch.einsum("bshl,lhv->bshv", out_lat.to(h.dtype), wuv)
    return project(params["wo"], out), cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    """Zero latent caches (batch, max_len, ...): under ``kv_seq`` the
    rank's block of the positions (``attention.kv_split``)."""
    m = cfg.mla
    S = kv_seq_block(max_len, kv_split()[0])[1]
    return {"c_kv": torch.zeros((batch, S, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, S, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
