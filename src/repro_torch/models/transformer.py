"""Block assembly: Engram-segmented layer stack (PyTorch port of
``repro.models.transformer``).

The stack is split into *segments* at the Engram insertion points, as in
the reference. The reference scans each segment's periodic tail over
stacked leaves; here every segment is a plain list of per-layer blocks run
as a Python loop, with per-layer parameter and cache lists.

The port has the dense GQA path: ``attn`` mixers with ``dense`` SwiGLU or
GeGLU FFNs, with the gemma2/gemma3 features (sliding-window ``local``
layers, a second RoPE base, qk-norms, post-block norms, softcaps).
``check_supported`` names the ROADMAP item for everything else.
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
    q_chunk: int = 1024
    kv_chunk: int = 1024
    chunk_threshold: int = 2048
    # local layers: slice the cache to the window during decode instead of
    # masking the full context
    decode_window_slice: bool = False


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any config feature outside this slice of the port."""
    other = "ROADMAP queue 1, item 8 (the other architecture families)"
    if cfg.is_encoder or cfg.frontend is not None:
        raise NotImplementedError(f"encoder/frontend archs: {other}")
    if cfg.attn_impl != "gqa" or any(t != "attn" for t in cfg.layer_types):
        raise NotImplementedError(f"non-GQA mixers (mla, mamba, xlstm): {other}")
    if any(f != "dense" for f in cfg.ffn_types):
        raise NotImplementedError(f"moe / ffn-less blocks: {other}")


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
    """The reference's leaf order: ln1, mixer, post_ln1, ln2, ffn,
    post_ln2 (the post-block norms only with ``cfg.post_block_norm``)."""
    d = {"ln1": rmsnorm_defs(cfg.d_model),
         "mixer": attn_defs(cfg, dtype, fan_in)}
    if cfg.post_block_norm:
        d["post_ln1"] = rmsnorm_defs(cfg.d_model)
    d["ln2"] = rmsnorm_defs(cfg.d_model)
    d["ffn"] = mlp_defs(cfg.d_model, cfg.d_ff, dtype, fan_in)
    if cfg.post_block_norm:
        d["post_ln2"] = rmsnorm_defs(cfg.d_model)
    return d


def segment_defs(cfg: ModelConfig, seg: Segment, dtype: str) -> list:
    """One block def per layer. Layers the reference stacks (its periodic
    tail) take the stacked leaf's fan-in, ``n_periods``."""
    return [block_defs(cfg, dtype,
                       0 if j < seg.prefix_len else seg.n_periods)
            for j in range(len(seg.layers))]


def apply_block(cfg: ModelConfig, flags: RunFlags, kind: str, params, h,
                positions, cache, mode: str):
    """One transformer block of attention kind ``kind`` (global | local).
    mode: prefill | decode. Returns (h, cache)."""
    pre = rmsnorm(params["ln1"], h, cfg.norm_eps)
    if mode == "decode":
        out, new_cache = decode_attention(
            cfg, params["mixer"], pre, cache, positions, kind,
            window_slice=flags.decode_window_slice)
    else:
        out, new_cache = attention(
            cfg, params["mixer"], pre, positions, kind, q_chunk=flags.q_chunk,
            kv_chunk=flags.kv_chunk, chunk_threshold=flags.chunk_threshold)
    if cfg.post_block_norm:
        out = rmsnorm(params["post_ln1"], out, cfg.norm_eps)
    h = h + out
    out2 = mlp(params["ffn"], rmsnorm(params["ln2"], h, cfg.norm_eps),
               cfg.ffn_act)
    if cfg.post_block_norm:
        out2 = rmsnorm(params["post_ln2"], out2, cfg.norm_eps)
    return h + out2, new_cache


def init_segment_cache(cfg: ModelConfig, seg: Segment, batch: int,
                       max_len: int, dtype: torch.dtype, device) -> list:
    return [init_kv_cache(cfg, batch, max_len, dtype, device)
            for _ in seg.layers]


def apply_segment(cfg: ModelConfig, flags: RunFlags, seg: Segment,
                  params: list, h, positions, cache, mode: str):
    """Returns (h, per-layer caches)."""
    new_cache = []
    for j, (li, p) in enumerate(zip(seg.layers, params)):
        c = cache[j] if cache is not None else None
        h, nc = apply_block(cfg, flags, cfg.attn_kinds[li], p, h, positions,
                            c, mode)
        new_cache.append(nc)
    return h, new_cache
