"""Block assembly: Engram-segmented layer stack (PyTorch port of
``repro.models.transformer``).

The stack is split into *segments* at the Engram insertion points, as in
the reference. The reference scans each segment's periodic tail over
stacked leaves; here every segment is a plain list of per-layer blocks run
as a Python loop, with per-layer parameter and cache lists.

The mixers are ``attn``, GQA (with the gemma2/gemma3 features:
sliding-window ``local`` layers, a second RoPE base, qk-norms, post-block
norms, softcaps) or MLA (``attn_impl="mla"``), and the recurrent ``mamba``,
``mlstm`` and ``slstm``; each is followed by a ``dense`` SwiGLU or GeGLU
FFN, a ``moe`` FFN, or none (``"none"``, xLSTM). A layer's cache is its
mixer's: positional KV for attention, recurrent state (``conv``/``ssm``;
``conv``/``C``/``n``/``m``; ``conv``/``c``/``n``/``h``/``m``) for the
others. An encoder (``cfg.is_encoder``) runs the same blocks in
``train`` mode, attention without the causal mask.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from .. import trace
from ..configs.base import ModelConfig
from ..sharding.rules import current_ctx, use_ctx
from .attention import attention, attn_defs, decode_attention, init_kv_cache
from .layers import mlp, mlp_defs, rmsnorm, rmsnorm_defs
from .mamba import init_mamba_cache, mamba_defs, mamba_forward
from .mla import init_mla_cache, mla_attention, mla_decode, mla_defs
from .moe import moe_defs, moe_ffn
from .xlstm import (init_xlstm_cache, mlstm_defs, mlstm_forward, slstm_defs,
                    slstm_forward)


@dataclass(frozen=True)
class RunFlags:
    """Runtime knobs that don't change parameters, only execution.

    ``remat`` checkpoints each period of a segment's stacked tail in train
    mode (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` of its scan body. ``logits_chunk`` and
    ``xent_remat`` are the loss's (``layers.chunked_xent``)."""
    remat: bool = False
    moe_strategy: str = "gather"     # dense | ragged | gather | alltoall
    engram_strategy: str | None = None
    q_chunk: int = 1024
    kv_chunk: int = 1024
    chunk_threshold: int = 2048
    logits_chunk: int = 2048
    # score products from bf16 q/k (or latents) summed in f32, without f32
    # copies of the KV cache (attention.f32_bmm): prefill, MLA, and GQA
    # decode on the CPU; GQA decode on the card runs K3, which sums those
    # same products in f32 either way
    attn_bf16_scores: bool = False
    # local layers: slice the cache to the window during decode instead of
    # masking the full context (the CPU's route; K3 on the card reads only
    # the window's keys either way)
    decode_window_slice: bool = False
    # vocab-sharded embedding under a mesh: masked local take + all_reduce
    # (layers.embed_lookup_local) instead of a whole-table lookup
    embed_local_gather: bool = False
    # the loss recomputes each logits chunk in backward instead of
    # keeping it
    xent_remat: bool = False


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

_MIXER_DEFS = {"mamba": mamba_defs, "mlstm": mlstm_defs,
               "slstm": slstm_defs}
_RECURRENT = {"mamba": mamba_forward, "mlstm": mlstm_forward,
              "slstm": slstm_forward}


def block_defs(cfg: ModelConfig, i: int, dtype: str, fan_in: int = 0):
    """Layer ``i``'s leaves in the reference's order: ln1, mixer (GQA, MLA,
    Mamba, mLSTM or sLSTM), post_ln1, then, unless the layer has no FFN,
    ln2, ffn (dense or MoE), post_ln2 (the post-block norms only with
    ``cfg.post_block_norm``)."""
    t, _, ffn = _sig(cfg, i)
    if t == "attn":
        mixer = mla_defs if cfg.attn_impl == "mla" else attn_defs
    else:
        mixer = _MIXER_DEFS[t]
    d = {"ln1": rmsnorm_defs(cfg.d_model),
         "mixer": mixer(cfg, dtype, fan_in)}
    if cfg.post_block_norm:
        d["post_ln1"] = rmsnorm_defs(cfg.d_model)
    if ffn == "none":
        return d
    d["ln2"] = rmsnorm_defs(cfg.d_model)
    d["ffn"] = moe_defs(cfg, dtype, fan_in) if ffn == "moe" \
        else mlp_defs(cfg.d_model, cfg.d_ff, dtype, fan_in)
    if cfg.post_block_norm:
        d["post_ln2"] = rmsnorm_defs(cfg.d_model)
    return d


def segment_defs(cfg: ModelConfig, seg: Segment, dtype: str) -> list:
    """One block def per layer. Layers the reference stacks (its periodic
    tail) take the stacked leaf's fan-in, ``n_periods``."""
    return [block_defs(cfg, li, dtype,
                       0 if j < seg.prefix_len else seg.n_periods)
            for j, li in enumerate(seg.layers)]


def apply_block(cfg: ModelConfig, flags: RunFlags, i: int, params, h,
                positions, cache, mode: str):
    """Layer ``i``'s block. mode: train (the loss, the encoder) | prefill
    | decode. Returns (h, cache, aux): ``aux`` is a MoE FFN's load-balance
    loss, else None. A recurrent mixer's prefill and train start from zero
    state (``cache`` None), its decode from ``cache``; each is one call
    over the token axis."""
    t, kind, ffn = _sig(cfg, i)
    mla = cfg.attn_impl == "mla"
    with trace.span("block.attn", layer=i):
        pre = rmsnorm(params["ln1"], h, cfg.norm_eps)
        if t != "attn":
            out, new_cache = _RECURRENT[t](cfg, params["mixer"], pre, cache)
        elif mode == "decode" and mla:
            out, new_cache = mla_decode(cfg, params["mixer"], pre, cache,
                                        positions,
                                        bf16_scores=flags.attn_bf16_scores)
        elif mode == "decode":
            out, new_cache = decode_attention(
                cfg, params["mixer"], pre, cache, positions, kind,
                bf16_scores=flags.attn_bf16_scores,
                window_slice=flags.decode_window_slice)
        else:
            out, new_cache = (mla_attention if mla else attention)(
                cfg, params["mixer"], pre, positions, kind,
                q_chunk=flags.q_chunk, kv_chunk=flags.kv_chunk,
                chunk_threshold=flags.chunk_threshold,
                bf16_scores=flags.attn_bf16_scores)
        if cfg.post_block_norm:
            out = rmsnorm(params["post_ln1"], out, cfg.norm_eps)
        h = h + out
    if ffn == "none":
        return h, new_cache, None
    with trace.span("block.ffn", layer=i):
        pre2 = rmsnorm(params["ln2"], h, cfg.norm_eps)
        aux = None
        if ffn == "moe":
            out2, aux = moe_ffn(cfg, params["ffn"], pre2,
                                strategy=flags.moe_strategy)
        else:
            out2 = mlp(params["ffn"], pre2, cfg.ffn_act, cfg.d_ff)
        if cfg.post_block_norm:
            out2 = rmsnorm(params["post_ln2"], out2, cfg.norm_eps)
        return h + out2, new_cache, aux


def init_block_cache(cfg: ModelConfig, i: int, batch: int, max_len: int,
                     dtype: torch.dtype, device) -> dict:
    """Layer ``i``'s empty decode cache, by its mixer type."""
    t = cfg.layer_types[i]
    if t == "attn":
        init = init_mla_cache if cfg.attn_impl == "mla" else init_kv_cache
        return init(cfg, batch, max_len, dtype, device)
    if t == "mamba":
        return init_mamba_cache(cfg, batch, dtype, device)
    return init_xlstm_cache(cfg, t, batch, dtype, device)


def init_segment_cache(cfg: ModelConfig, seg: Segment, batch: int,
                       max_len: int, dtype: torch.dtype, device) -> list:
    return [init_block_cache(cfg, i, batch, max_len, dtype, device)
            for i in seg.layers]


def apply_segment(cfg: ModelConfig, flags: RunFlags, seg: Segment,
                  params: list, h, positions, cache, mode: str):
    """Returns (h, per-layer caches, aux): in train mode ``aux`` is the
    f32 sum of the MoE layers' load-balance losses, which the loss adds;
    serving drops them (aux None).

    With ``flags.remat`` in train mode each period of the stacked tail
    (``seg.period`` layers from ``prefix_len``; the reference's scan body)
    runs under ``torch.utils.checkpoint``: backward recomputes its
    activations. The unrolled prefix is not checkpointed, as in the
    reference."""
    if mode != "train":
        new_cache = []
        for j, (li, p) in enumerate(zip(seg.layers, params)):
            c = cache[j] if cache is not None else None
            h, nc, _ = apply_block(cfg, flags, li, p, h, positions, c, mode)
            new_cache.append(nc)
        return h, new_cache, None

    ctx = current_ctx()

    def run(h_, a, *ps, start):
        # backward recomputes a checkpointed period on the autograd
        # engine's thread for CUDA tensors, where the mesh's context (a
        # thread-local) is not set: the period carries its own
        with use_ctx(ctx):
            for li, p in zip(seg.layers[start:start + len(ps)], ps):
                h_, _, ax = apply_block(cfg, flags, li, p, h_, positions,
                                        None, mode)
                if ax is not None:
                    a = a + ax
        return h_, a

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = flags.remat and seg.period
    for start in range(len(seg.layers)):
        if start < seg.prefix_len or not remat:
            h, aux = run(h, aux, params[start], start=start)
        elif (start - seg.prefix_len) % seg.period == 0:
            h, aux = torch.utils.checkpoint.checkpoint(
                run, h, aux, *params[start:start + seg.period], start=start,
                use_reentrant=False)
    return h, [None] * len(seg.layers), aux
