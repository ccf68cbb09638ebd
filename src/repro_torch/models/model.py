"""Full model: frontends -> embedding -> Engram-segmented stack -> f32 head
(PyTorch port of ``repro.models.model``).

Step builders, as in the reference:

  build_prefill_step(cfg, flags, max_len)   (params, batch) -> (logits, state)
  build_decode_step(cfg, flags, external_rows)
                                            (params, state, token[, rows])
                                              -> (logits, state)

The Engram retrieval for every Engram layer is issued before the block
stack (it depends only on token IDs), and each Engram layer fuses its rows
into the hidden state through the gated_fuse kernel (K2).

  build_chunk_prefill(cfg, flags)          (params, state, chunk, lens)
                                              -> (logits, state)
  build_multitoken_decode(cfg, flags, external_rows)
                                            (params, state, block[, rows])
                                              -> (logits, state, snapshots)
  build_encoder_step(cfg, flags)           (params, batch) -> logits (B,S,V)

The stub frontends: an audio encoder's batch carries ``frames`` (B, S,
frontend_dim), normed and projected in place of the token embedding; a
vision model's may carry ``patches`` (B, P, frontend_dim), normed,
projected and written over positions [0, P) of the token embedding. An
encoder has no prefill or decode step: ``build_prefill_step``,
``build_decode_step``, ``build_multitoken_decode`` and
``build_chunk_prefill`` raise ``ValueError`` for it.

Decode updates the state's KV caches in place (see
``attention.decode_attention``); recurrent cache leaves (Mamba, xLSTM),
``positions`` and ``last_tokens`` are new tensors each step, the last two
int32 as in the reference (a prefix snapshot's byte count, which the pool
link is charged, depends on their width).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.engram import engram_defs, engram_fuse, retrieve
from ..core.hashing import (decode_engram_indices, engram_indices,
                            update_last_tokens)
from .layers import (embed_defs, embed_lookup, head_defs, head_logits,
                     rmsnorm, rmsnorm_defs, scale_embeddings)
from .params import DTYPES, init_params, pd  # noqa: F401  (re-exported)
from .transformer import (RunFlags, apply_segment, init_segment_cache,
                          segment_defs, segment_plan)


def model_defs(cfg: ModelConfig, dtype: str | None = None):
    """Parameter shapes: per-segment lists of per-layer block defs."""
    dtype = dtype or cfg.dtype
    defs = {
        "embed": embed_defs(cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": rmsnorm_defs(cfg.d_model),
        "segments": [segment_defs(cfg, seg, dtype)
                     for seg in segment_plan(cfg)],
    }
    if not cfg.tie_embeddings:
        defs["head"] = head_defs(cfg.vocab_size, cfg.d_model, dtype)
    if cfg.frontend is not None:
        defs["frontend"] = {
            "proj": pd(cfg.frontend_dim, cfg.d_model, dtype=dtype),
            "norm": rmsnorm_defs(cfg.frontend_dim),
        }
    if cfg.engram is not None and cfg.engram.enabled and cfg.engram_layers():
        defs["engram"] = engram_defs(cfg, dtype)
    return defs


def _engram_rows_all_layers(cfg: ModelConfig, flags: RunFlags, params, idx):
    """Retrieve rows for every Engram layer up front. idx (B,S,T)."""
    return [retrieve(cfg.engram, layer["tables"], idx, flags.engram_strategy)
            for layer in params["engram"]["layers"]]


def _project(cfg: ModelConfig, params, x):
    """A frontend's features x (..., frontend_dim), RMS-normed and
    projected to d_model, in JAX's promoted dtype of x and the projection
    (f32 features and a bf16 projection give f32)."""
    p = params["frontend"]
    dt = torch.promote_types(x.dtype, p["proj"].dtype)
    return rmsnorm(p["norm"], x, cfg.norm_eps).to(dt) @ p["proj"].to(dt)


def embed_inputs(cfg: ModelConfig, params, batch):
    """batch: tokens (B,S) [+ frames (B,S,fe) audio | patches (B,P,fe)
    vision]. Audio frames replace the token embedding; vision patches
    overwrite positions [0, P) when the batch carries them. The embedding
    scale applies after either, then the config's dtype."""
    if cfg.frontend == "audio":
        h = _project(cfg, params, batch["frames"])
    else:
        h = embed_lookup(params["embed"], batch["tokens"])
        if cfg.frontend == "vision" and "patches" in batch:
            pe = _project(cfg, params, batch["patches"]).to(h.dtype)
            h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    if cfg.scale_embeddings:
        h = scale_embeddings(h, cfg.d_model)
    return h.to(DTYPES[cfg.dtype])


def forward(cfg: ModelConfig, flags: RunFlags, params, batch, mode: str,
            positions=None, caches=None, engram_rows=None):
    """Shared forward. Returns (h_final, new_caches).

    mode train (the encoder) or prefill: positions (S,) default arange;
    decode: (B,)."""
    h = embed_inputs(cfg, params, batch)
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)

    rows = []
    if cfg.engram_layers() and "engram" in params:
        if engram_rows is not None:
            rows = engram_rows
        else:
            rows = _engram_rows_all_layers(
                cfg, flags, params,
                engram_indices(cfg.engram, batch["tokens"]))

    new_caches = []
    for si, seg in enumerate(segment_plan(cfg)):
        if si > 0 and rows:
            # segment boundary == Engram layer: fuse before the block (K2)
            h = engram_fuse(cfg, params["engram"]["layers"][si - 1], h,
                            rows[si - 1], use_kernel=True)
        c = caches[si] if caches is not None else None
        h, nc = apply_segment(cfg, flags, seg, params["segments"][si], h,
                              positions, c, mode)
        new_caches.append(nc)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), new_caches


def _head_params(cfg: ModelConfig, params):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def init_decode_state(cfg: ModelConfig, flags: RunFlags, batch: int,
                      max_len: int, device) -> dict:
    dtype = DTYPES[cfg.dtype]
    max_order = max(cfg.engram.orders) if cfg.engram_layers() else 1
    pad = cfg.engram.pad_token if cfg.engram else 0
    return {
        "caches": [init_segment_cache(cfg, seg, batch, max_len, dtype, device)
                   for seg in segment_plan(cfg)],
        "positions": torch.zeros((batch,), dtype=torch.int32, device=device),
        "last_tokens": torch.full((batch, max_order - 1), pad,
                                  dtype=torch.int32, device=device),
    }


# KV-cache leaves: positional, masked by ``positions`` (sequence axis 1);
# every other cache leaf is recurrent state
KV_KEYS = frozenset({"k", "v", "c_kv", "k_rope"})


def pad_kv(t: torch.Tensor, max_len: int) -> torch.Tensor:
    """A KV leaf zero-padded along its sequence axis, axis 1 (k/v are
    (B, S, H, D), the MLA latents c_kv/k_rope (B, S, R)), out to
    ``max_len`` positions."""
    n = max_len - t.shape[1]
    if n <= 0:
        return t
    return torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, n))


def _pad_caches_to(caches, max_len: int):
    """Pad the prefill caches' KV leaves out to decode capacity; recurrent
    leaves (``conv`` (B, K-1, di) among them) stay as they are."""
    return [[{n: pad_kv(t, max_len) if n in KV_KEYS else t
              for n, t in c.items()} for c in seg] for seg in caches]


def _no_encoder(cfg: ModelConfig) -> None:
    """The reference asserts it in every ``build_*`` function but
    ``build_encoder_step``."""
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is an encoder: it has no prefill or "
                         f"decode step (build_encoder_step)")


def build_prefill_step(cfg: ModelConfig, flags: RunFlags, max_len: int = 0):
    """(params, batch{tokens, [lengths], [patches]}) -> (last_logits,
    state)."""
    _no_encoder(cfg)

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
        logits = head_logits(_head_params(cfg, params), h_last[:, 0],
                             cfg.final_logit_softcap, cfg.tie_embeddings)
        caches = _pad_caches_to(caches, max_len or S)
        no = (max(cfg.engram.orders) if cfg.engram_layers() else 1) - 1
        # the reference's dynamic_slice: start max(l - no, 0), clamped so
        # the window fits inside the row
        start = (lengths - no).clamp(min=0, max=max(S - no, 0))
        cols = start[:, None] + torch.arange(no, device=tokens.device)
        last = tokens.gather(1, cols).to(torch.int32)
        state = {"caches": caches, "positions": lengths.to(torch.int32),
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
    # int64 once per step: int32 indices would be widened in every layer
    h, new_caches = forward(cfg, flags, params, {"tokens": token[:, None]},
                            "decode", positions=positions.long(),
                            caches=state["caches"], engram_rows=rows)
    logits = head_logits(_head_params(cfg, params), h[:, 0],
                         cfg.final_logit_softcap, cfg.tie_embeddings)
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
    _no_encoder(cfg)
    if external_rows:
        return lambda params, state, token, rows: _decode_one(
            cfg, flags, params, state, token, rows)
    return lambda params, state, token: _decode_one(cfg, flags, params,
                                                    state, token)


def build_multitoken_decode(cfg: ModelConfig, flags: RunFlags,
                            external_rows: bool = False):
    """Multi-token verify step for speculative decoding.

    (params, state, block (B,m) [, rows]) ->
        (logits (B,m,V), final_state, snapshots)

    Unrolls m single-token decode steps over the block: position s attends
    the block's earlier positions through the in-place KV writes, exactly
    as sequential decode would, so accepted tokens are bit-identical to
    greedy decode. A ``snapshot_recurrent`` of the state is recorded before
    the first step and after every step, for per-slot rollback
    (``serving.slots.rollback_state``).

    ``external_rows=True``: per-layer rows for the WHOLE block,
    (B, m, orders*emb) each (the engine's speculated-window prefetch);
    step s takes ``r[:, s:s+1]``."""
    _no_encoder(cfg)
    from ..serving.slots import snapshot_recurrent

    def multitoken_step(params, state, block, rows=None):
        snaps = [snapshot_recurrent(state)]
        logits_all = []
        st = state
        for s in range(block.shape[1]):
            rows_s = None if rows is None else [r[:, s:s + 1] for r in rows]
            logits, st = _decode_one(cfg, flags, params, st, block[:, s],
                                     rows_s)
            logits_all.append(logits)
            snaps.append(snapshot_recurrent(st))
        return torch.stack(logits_all, dim=1), st, snaps

    if external_rows:
        return lambda params, state, block, rows: multitoken_step(
            params, state, block, rows)
    return lambda params, state, block: multitoken_step(params, state, block)


def build_chunk_prefill(cfg: ModelConfig, flags: RunFlags):
    """Chunked-prefill step for ragged admission.

    (params, state, chunk (B,C), lens (B,)) -> (logits (B,V), new_state)

    Unrolls C single-token decode steps over a chunk of each row's prompt,
    from the per-row offset in ``state['positions']``. Rows whose chunk is
    shorter than C (``lens``) stop advancing at their length
    (``serving.slots.gate_state``); the logits returned are each row's
    last valid step's, which for a prompt's final chunk are the prefill
    logits its first token is sampled from. The caches are written in
    place."""
    _no_encoder(cfg)
    from ..serving.slots import gate_state

    def chunk_step(params, state, chunk, lens):
        logits_keep = None
        st = state
        for s in range(chunk.shape[1]):
            valid = lens > s
            logits, new_st = _decode_one(cfg, flags, params, st, chunk[:, s])
            st = gate_state(valid, new_st, st)
            logits_keep = logits if logits_keep is None else \
                torch.where(valid[:, None], logits, logits_keep)
        return logits_keep, st

    return chunk_step


def build_encoder_step(cfg: ModelConfig, flags: RunFlags):
    """Encoder forward: (params, batch) -> logits (B,S,V), f32."""
    def encoder_step(params, batch):
        h, _ = forward(cfg, flags, params, batch, "train")
        return head_logits(_head_params(cfg, params), h,
                           cfg.final_logit_softcap, cfg.tie_embeddings)
    return encoder_step
