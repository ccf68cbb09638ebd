"""Block assembly: Engram-segmented layer stack (PyTorch port of
``repro.models.transformer``).

The stack is split into *segments* at the Engram insertion points, as in
the reference. The reference scans each segment's periodic tail over
stacked leaves; here every segment is a plain list of per-layer blocks run
as a Python loop, with per-layer parameter and cache lists.

This slice ports the dense GQA path: ``attn`` mixers with ``dense`` SwiGLU
FFNs. ``check_supported`` names the ROADMAP item for everything else.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig
from .attention import attention, attn_defs, decode_attention, init_kv_cache
from .layers import mlp, mlp_defs, rmsnorm, rmsnorm_defs


@dataclass(frozen=True)
class RunFlags:
    """Runtime knobs that don't change parameters, only execution."""
    engram_strategy: str | None = None
    chunk_threshold: int = 2048


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any config feature outside this slice of the port."""
    other = "ROADMAP queue 1, item 8 (the other architecture families)"
    if cfg.is_encoder or cfg.frontend is not None:
        raise NotImplementedError(f"encoder/frontend archs: {other}")
    if cfg.attn_impl != "gqa" or any(t != "attn" for t in cfg.layer_types):
        raise NotImplementedError(f"non-GQA mixers (mla, mamba, xlstm): {other}")
    if any(f != "dense" for f in cfg.ffn_types):
        raise NotImplementedError(f"moe / ffn-less blocks: {other}")
    if cfg.window_size > 0 or any(k != "global" for k in cfg.attn_kinds):
        raise NotImplementedError(f"sliding-window layers: {other}")
    if (cfg.qk_norm or cfg.post_block_norm or cfg.tie_embeddings
            or cfg.scale_embeddings):
        raise NotImplementedError(f"qk/post norms, tied or scaled "
                                  f"embeddings: {other}")
    if cfg.spec is not None and cfg.spec.enabled:
        raise NotImplementedError("speculative decoding: ROADMAP queue 1, "
                                  "item 4 (speculation)")


def _sig(cfg: ModelConfig, i: int) -> tuple:
    return (cfg.layer_types[i], cfg.attn_kinds[i], cfg.ffn_types[i])


# ---------------------------------------------------------------------------
# segment planning (identical to the reference's)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Segment:
    layers: tuple[int, ...]          # absolute layer indices
    prefix_len: int                  # first prefix_len layers unrolled
    period: int                      # 0 => fully unrolled
    n_periods: int


def segment_plan(cfg: ModelConfig) -> list[Segment]:
    L = cfg.n_layers
    bounds = sorted({0, L, *[l for l in cfg.engram_layers() if 0 < l < L]})
    return [_plan_one(cfg, tuple(range(a, b)))
            for a, b in zip(bounds[:-1], bounds[1:])]


def _plan_one(cfg: ModelConfig, idxs: tuple[int, ...]) -> Segment:
    n = len(idxs)
    sigs = [_sig(cfg, i) for i in idxs]
    best = None
    for k in range(0, min(n, 9)):                 # prefix length
        rest = n - k
        for p in range(1, 9):
            if rest < 2 * p or rest % p:
                continue
            pat = sigs[k:k + p]
            if all(sigs[k + j] == pat[j % p] for j in range(rest)):
                cand = (k + p, k, p)              # cost = unrolled layers
                if best is None or cand < best:
                    best = cand
                break
    if best is None:
        return Segment(idxs, n, 0, 0)
    _, k, p = best
    return Segment(idxs, k, p, (n - k) // p)


# ---------------------------------------------------------------------------
# per-block defs / apply
# ---------------------------------------------------------------------------

def block_defs(cfg: ModelConfig, dtype: str, fan_in: int = 0):
    return {"ln1": rmsnorm_defs(cfg.d_model),
            "mixer": attn_defs(cfg, dtype, fan_in),
            "ln2": rmsnorm_defs(cfg.d_model),
            "ffn": mlp_defs(cfg.d_model, cfg.d_ff, dtype, fan_in)}


def segment_defs(cfg: ModelConfig, seg: Segment, dtype: str) -> list:
    """One block def per layer. Layers the reference stacks (its periodic
    tail) take the stacked leaf's fan-in, ``n_periods``."""
    return [block_defs(cfg, dtype,
                       0 if j < seg.prefix_len else seg.n_periods)
            for j in range(len(seg.layers))]


def apply_block(cfg: ModelConfig, flags: RunFlags, params, h, positions,
                cache, mode: str):
    """One transformer block. mode: prefill | decode. Returns (h, cache)."""
    pre = rmsnorm(params["ln1"], h, cfg.norm_eps)
    if mode == "decode":
        out, new_cache = decode_attention(cfg, params["mixer"], pre, cache,
                                          positions)
    else:
        out, new_cache = attention(cfg, params["mixer"], pre, positions,
                                   chunk_threshold=flags.chunk_threshold)
    h = h + out
    pre2 = rmsnorm(params["ln2"], h, cfg.norm_eps)
    return h + mlp(params["ffn"], pre2, cfg.ffn_act), new_cache


def init_segment_cache(cfg: ModelConfig, seg: Segment, batch: int,
                       max_len: int, dtype: torch.dtype, device) -> list:
    return [init_kv_cache(cfg, batch, max_len, dtype, device)
            for _ in seg.layers]


def apply_segment(cfg: ModelConfig, flags: RunFlags, params: list, h,
                  positions, cache, mode: str):
    """Returns (h, per-layer caches)."""
    new_cache = []
    for j, p in enumerate(params):
        c = cache[j] if cache is not None else None
        h, nc = apply_block(cfg, flags, p, h, positions, c, mode)
        new_cache.append(nc)
    return h, new_cache
