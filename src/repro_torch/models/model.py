"""Full model: embedding -> Engram-segmented stack -> f32 head (PyTorch port
of ``repro.models.model``).

Step builders, as in the reference:

  build_prefill_step(cfg, flags, max_len)   (params, batch) -> (logits, state)
  build_decode_step(cfg, flags, external_rows)
                                            (params, state, token[, rows])
                                              -> (logits, state)

The Engram retrieval for every Engram layer is issued before the block
stack (it depends only on token IDs), and each Engram layer fuses its rows
into the hidden state through the gated_fuse kernel (K2).

Decode updates the state's KV caches in place (see
``attention.decode_attention``); ``positions`` and ``last_tokens`` are new
tensors each step.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.engram import engram_defs, engram_fuse, retrieve
from ..core.hashing import (decode_engram_indices, engram_indices,
                            update_last_tokens)
from .layers import (embed_defs, embed_lookup, head_defs, head_logits,
                     rmsnorm, rmsnorm_defs)
from .params import DTYPES, init_params  # noqa: F401  (re-exported)
from .transformer import (RunFlags, apply_segment, check_supported,
                          init_segment_cache, segment_defs, segment_plan)


def model_defs(cfg: ModelConfig, dtype: str | None = None):
    """Parameter shapes: per-segment lists of per-layer block defs."""
    check_supported(cfg)
    dtype = dtype or cfg.dtype
    defs = {
        "embed": embed_defs(cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": rmsnorm_defs(cfg.d_model),
        "segments": [segment_defs(cfg, seg, dtype)
                     for seg in segment_plan(cfg)],
        "head": head_defs(cfg.vocab_size, cfg.d_model, dtype),
    }
    if cfg.engram is not None and cfg.engram.enabled and cfg.engram_layers():
        defs["engram"] = engram_defs(cfg, dtype)
    return defs


def _engram_rows_all_layers(cfg: ModelConfig, flags: RunFlags, params, idx):
    """Retrieve rows for every Engram layer up front. idx (B,S,T)."""
    return [retrieve(cfg.engram, layer["tables"], idx, flags.engram_strategy)
            for layer in params["engram"]["layers"]]


def forward(cfg: ModelConfig, flags: RunFlags, params, batch, mode: str,
            positions=None, caches=None, engram_rows=None):
    """Shared forward. Returns (h_final, new_caches).

    mode prefill: positions (S,) default arange; decode: (B,)."""
    tokens = batch["tokens"]
    h = embed_lookup(params["embed"], tokens).to(DTYPES[cfg.dtype])
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)

    rows = []
    if cfg.engram_layers() and "engram" in params:
        if engram_rows is not None:
            rows = engram_rows
        else:
            rows = _engram_rows_all_layers(
                cfg, flags, params, engram_indices(cfg.engram, tokens))

    new_caches = []
    for si, seg in enumerate(segment_plan(cfg)):
        if si > 0 and rows:
            # segment boundary == Engram layer: fuse before the block (K2)
            h = engram_fuse(cfg, params["engram"]["layers"][si - 1], h,
                            rows[si - 1], use_kernel=True)
        c = caches[si] if caches is not None else None
        h, nc = apply_segment(cfg, flags, params["segments"][si], h,
                              positions, c, mode)
        new_caches.append(nc)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), new_caches


def init_decode_state(cfg: ModelConfig, flags: RunFlags, batch: int,
                      max_len: int, device) -> dict:
    dtype = DTYPES[cfg.dtype]
    max_order = max(cfg.engram.orders) if cfg.engram_layers() else 1
    pad = cfg.engram.pad_token if cfg.engram else 0
    return {
        "caches": [init_segment_cache(cfg, seg, batch, max_len, dtype, device)
                   for seg in segment_plan(cfg)],
        "positions": torch.zeros((batch,), dtype=torch.int64, device=device),
        "last_tokens": torch.full((batch, max_order - 1), pad,
                                  dtype=torch.int64, device=device),
    }


def _pad_caches_to(caches, max_len: int):
    """Pad prefill k/v caches (B, S, H, D) out to decode capacity."""
    def pad(kv):
        return {n: torch.nn.functional.pad(
                    t, (0, 0, 0, 0, 0, max_len - t.shape[1]))
                if t.shape[1] < max_len else t for n, t in kv.items()}
    return [[pad(kv) for kv in seg] for seg in caches]


def build_prefill_step(cfg: ModelConfig, flags: RunFlags, max_len: int = 0):
    """(params, batch{tokens, [lengths]}) -> (last_logits, state)."""
    check_supported(cfg)

    def prefill_step(params, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        h, caches = forward(cfg, flags, params, batch, "prefill")
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int64,
                                 device=tokens.device)
        h_last = h.gather(1, (lengths - 1).view(B, 1, 1).expand(
            B, 1, h.shape[-1]))
        logits = head_logits(params["head"], h_last[:, 0],
                             cfg.final_logit_softcap)
        caches = _pad_caches_to(caches, max_len or S)
        no = (max(cfg.engram.orders) if cfg.engram_layers() else 1) - 1
        # the reference's dynamic_slice: start max(l - no, 0), clamped so
        # the window fits inside the row
        start = (lengths - no).clamp(min=0, max=max(S - no, 0))
        cols = start[:, None] + torch.arange(no, device=tokens.device)
        last = tokens.to(torch.int64).gather(1, cols)
        state = {"caches": caches, "positions": lengths.to(torch.int64),
                 "last_tokens": last}
        return logits, state

    return prefill_step


def _decode_one(cfg: ModelConfig, flags: RunFlags, params, state, token,
                rows=None):
    """One decode step: (state, token (B,)) -> (logits (B,V), new_state)."""
    positions = state["positions"]
    if cfg.engram_layers() and "engram" in params and rows is None:
        idx = decode_engram_indices(cfg.engram, state["last_tokens"], token)
        rows = _engram_rows_all_layers(cfg, flags, params, idx)
    h, new_caches = forward(cfg, flags, params, {"tokens": token[:, None]},
                            "decode", positions=positions,
                            caches=state["caches"], engram_rows=rows)
    logits = head_logits(params["head"], h[:, 0], cfg.final_logit_softcap)
    new_state = {
        "caches": new_caches,
        "positions": positions + 1,
        "last_tokens": update_last_tokens(state["last_tokens"], token),
    }
    return logits, new_state


def build_decode_step(cfg: ModelConfig, flags: RunFlags,
                      external_rows: bool = False):
    """(params, state, token (B,) [, rows]) -> (logits (B,V), new_state).

    ``external_rows=True`` takes the Engram rows as an argument — the
    serving engine's prefetch path."""
    check_supported(cfg)
    if external_rows:
        return lambda params, state, token, rows: _decode_one(
            cfg, flags, params, state, token, rows)
    return lambda params, state, token: _decode_one(cfg, flags, params,
                                                    state, token)
