"""Full model: frontends -> embedding -> Engram-segmented stack -> f32 head
(PyTorch port of ``repro.models.model``).

Step builders, as in the reference:

  build_loss_fn(cfg, flags)                 (params, batch) -> loss (train)
  build_prefill_step(cfg, flags, max_len)   (params, batch) -> (logits, state)
  build_decode_step(cfg, flags, external_rows)
                                            (params, state, token[, rows])
                                              -> (logits, state)

The Engram retrieval for every Engram layer is issued before the block
stack (it depends only on token IDs), and each Engram layer fuses its rows
into the hidden state through the gated_fuse kernel (K2) when serving; the
loss fuses them in the reference model's plain form under autograd (K2
has no backward). The serving steps run under ``torch.no_grad``.

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

Under a sharding context every step runs on the rank's blocks of
``mesh_logical_axes`` (the reference's layout but for ``WHOLE_LEAVES``)
and its share of the batch; the serving steps return the logits of the
whole vocabulary, gathered over "vocab" (``head_logits`` computes the
rank's block of them), and the decode state's blocks are those of the
reference's state layout (``init_decode_state``).
"""
from __future__ import annotations

import torch

from .. import trace
from ..configs.base import ModelConfig
from ..core.engram import engram_defs, engram_fuse, retrieve
from ..core.hashing import (decode_engram_indices, engram_indices,
                            update_last_tokens)
from ..sharding import collectives as coll
from ..sharding.rules import current_ctx
from .attention import kv_seq_block, kv_split
from .layers import (chunked_xent, embed_defs, embed_lookup,
                     embed_lookup_local, head_defs, head_logits, rmsnorm,
                     rmsnorm_defs, scale_embeddings, vocab_block)
from .params import DTYPES, init_params, pd  # noqa: F401  (re-exported)
from .params import tree_axes, tree_map, tree_paths
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


def params_logical_axes(cfg: ModelConfig):
    """The logical axes of every parameter, in ``model_defs``' structure."""
    return tree_axes(model_defs(cfg))


# leaves the port keeps whole where the reference's layout splits them,
# by leaf name, and why (ROADMAP lists them too)
WHOLE_LEAVES = {
    "proj": "each Engram layer's fusion projection: K2 fuses e·Wp with the "
            "gate and reads Wp whole, and the RMS norm before it needs "
            "whole rows",
}


def _is_whole_leaf(path: str) -> bool:
    return path.startswith("engram/") and path.rsplit("/", 1)[-1] in \
        WHOLE_LEAVES


def mesh_logical_axes(cfg: ModelConfig):
    """The layout a rank serves on: ``params_logical_axes`` (the
    reference's, which ``params_shardings`` places) with the leaves of
    ``WHOLE_LEAVES`` whole. ``sharding.rules.local_params(params,
    mesh_logical_axes(cfg))`` gives a rank what the forward under a mesh
    reads."""
    axes = params_logical_axes(cfg)
    for layer in axes.get("engram", {}).get("layers", []):
        for name in WHOLE_LEAVES:
            layer[name] = (None,) * len(layer[name])
    return axes


def whole_leaves(cfg: ModelConfig, ctx) -> dict:
    """path -> bytes of every leaf the rank holds whole under ``ctx``
    where the reference's layout would split it (``WHOLE_LEAVES``)."""
    axes = dict(tree_paths(params_logical_axes(cfg), is_leaf=lambda x:
                           isinstance(x, tuple)))
    return {path: t.numel() * t.element_size()
            for path, t in tree_paths(abstract_params(cfg))
            if _is_whole_leaf(path) and ctx.spec_for(tuple(t.shape),
                                                     axes[path])}


def train_logical_axes(cfg: ModelConfig, flags: RunFlags = RunFlags()):
    """The layout a rank trains on under ``flags``: ``mesh_logical_axes``,
    except that the Engram tables follow the retrieval strategy
    (``flags.engram_strategy``, else the config's): ``pooled`` keeps them
    split over every axis; ``tp`` takes the rank's block over the model
    axis, whole along the others, since ``retrieve_tp`` reads rows split
    over the model axis alone, as the reference's ``shard_map`` reshards
    them (their rows then take ``eng_emb``'s axes, the axis ``tp`` splits
    the fused dim over); any other strategy reads them whole."""
    axes = mesh_logical_axes(cfg)
    strategy = flags.engram_strategy or (
        cfg.engram.strategy if cfg.engram else None)
    for layer in axes.get("engram", {}).get("layers", []):
        if strategy == "tp":
            layer["tables"] = tuple("eng_emb" if a == "eng_vocab" else a
                                    for a in layer["tables"])
        elif strategy != "pooled":
            layer["tables"] = (None,) * len(layer["tables"])
    return axes


def _engram_rows_all_layers(cfg: ModelConfig, flags: RunFlags, params, idx,
                            mode: str):
    """Retrieve rows for every Engram layer up front. idx (B,S,T). Under a
    mesh ``tp`` gives each rank its block of the fused dim; the blocks are
    reassembled here, since the port's fusion reads whole rows. In mode
    ``train`` ``pooled``'s owners read without K1 (no backward)."""
    rows = [retrieve(cfg.engram, layer["tables"], idx, flags.engram_strategy,
                     use_kernel=mode != "train")
            for layer in params["engram"]["layers"]]
    F = len(cfg.engram.orders) * cfg.engram.emb_dim
    if rows and rows[0].shape[-1] != F:
        rows = [coll.gather_dim(r, ("model",), 2) for r in rows]
    return rows


def _project(cfg: ModelConfig, params, x):
    """A frontend's features x (..., frontend_dim), RMS-normed and
    projected to d_model, in JAX's promoted dtype of x and the projection
    (f32 features and a bf16 projection give f32)."""
    p = params["frontend"]
    dt = torch.promote_types(x.dtype, p["proj"].dtype)
    return rmsnorm(p["norm"], x, cfg.norm_eps).to(dt) @ p["proj"].to(dt)


def embed_inputs(cfg: ModelConfig, params, batch,
                 flags: RunFlags = RunFlags()):
    """batch: tokens (B,S) [+ frames (B,S,fe) audio | patches (B,P,fe)
    vision]. Audio frames replace the token embedding; vision patches
    overwrite positions [0, P) when the batch carries them. The embedding
    scale applies after either, then the config's dtype. With
    ``flags.embed_local_gather``, or under a sharding context (which
    splits the table over "vocab"), the tokens go through
    ``embed_lookup_local`` (the table whole or the rank's block)."""
    if cfg.frontend == "audio":
        h = _project(cfg, params, batch["frames"])
    else:
        if flags.embed_local_gather or current_ctx() is not None:
            h = embed_lookup_local(params["embed"], batch["tokens"],
                                   cfg.vocab_size)
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
    """Shared forward. Returns (h_final, new_caches, aux): aux is the
    summed MoE load-balance loss in train mode, else None.

    mode train (the loss, the encoder) or prefill: positions (S,) default
    arange; decode: (B,). Mode ``train`` fuses the Engram rows in the
    reference model's plain form (``engram_fuse(use_kernel=False)``),
    under autograd; every other mode through K2, which has no backward."""
    h = embed_inputs(cfg, params, batch, flags)
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)

    rows = []
    if cfg.engram_layers() and "engram" in params:
        if engram_rows is not None:
            rows = engram_rows
        else:
            rows = _engram_rows_all_layers(
                cfg, flags, params,
                engram_indices(cfg.engram, batch["tokens"]), mode)

    new_caches = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device) \
        if mode == "train" else None
    for si, seg in enumerate(segment_plan(cfg)):
        if si > 0 and rows:
            # segment boundary == Engram layer: fuse before the block
            h = engram_fuse(cfg, params["engram"]["layers"][si - 1], h,
                            rows[si - 1], use_kernel=mode != "train")
        c = caches[si] if caches is not None else None
        h, nc, a = apply_segment(cfg, flags, seg, params["segments"][si], h,
                                 positions, c, mode)
        if a is not None:
            aux = aux + a
        new_caches.append(nc)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), new_caches, aux


def _head_params(cfg: ModelConfig, params):
    return params["embed"] if cfg.tie_embeddings else params["head"]


def _logits(cfg: ModelConfig, params, h):
    """f32 logits of the whole vocabulary: under a sharding context the
    rank's block (``head_logits``) gathered over "vocab"."""
    with trace.span("model.head", T=h.numel() // h.shape[-1]):
        logits = head_logits(_head_params(cfg, params), h,
                             cfg.final_logit_softcap, cfg.tie_embeddings,
                             vocab=cfg.vocab_size)
        axes = vocab_block(cfg.vocab_size)[2]
        return coll.gather_dim(logits, axes, logits.dim() - 1) if axes \
            else logits


def abstract_params(cfg: ModelConfig, dtype: str | None = None):
    """The parameter tree's shapes and dtypes, as tensors on the ``meta``
    device (nothing allocated)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=DTYPES[d.dtype],
                                          device="meta"),
                    model_defs(cfg, dtype))


def build_loss_fn(cfg: ModelConfig, flags: RunFlags):
    """(params, batch{tokens, labels, [loss_mask], [frames | patches]}) ->
    the f32 scalar loss: the mean cross-entropy of the f32 head
    (``chunked_xent`` over ``flags.logits_chunk`` positions a chunk) plus
    the MoE layers' load-balance losses, differentiable by autograd. Runs
    no kernel: the Engram rows are gathered by ``retrieve``'s plain
    strategies and fused in the plain form, as the reference's loss does
    (K1 and K2 have no backward)."""
    def loss_fn(params, batch):
        h, _, aux = forward(cfg, flags, params, batch, "train")
        loss = chunked_xent(_head_params(cfg, params), h, batch["labels"],
                            batch.get("loss_mask"),
                            final_cap=cfg.final_logit_softcap,
                            tied=cfg.tie_embeddings,
                            chunk=flags.logits_chunk,
                            remat_body=flags.xent_remat,
                            vocab=cfg.vocab_size)
        return loss + aux
    return loss_fn


def init_decode_state(cfg: ModelConfig, flags: RunFlags, batch: int,
                      max_len: int, device) -> dict:
    """An empty decode state for ``batch`` rows of up to ``max_len``
    positions; under a sharding context ``batch`` is the rank's share and
    each cache its block of the reference's state layout (KV heads over
    "kv_heads", under ``kv_seq`` the KV sequence over its axes, recurrent
    channels over "ffn", heads over "heads")."""
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


def kv_block(t: torch.Tensor, max_len: int, seq: tuple = ()) -> torch.Tensor:
    """``pad_kv(t, max_len)``, or under ``kv_seq`` (``seq``, the axes of
    ``attention.kv_split``) the rank's block of it: its ``max_len / n``
    positions, the prompt's where they reach them and zeros past it, in
    a storage of its own."""
    if not seq:
        return pad_kv(t, max_len)
    start, n = kv_seq_block(max_len, seq)
    out = t.new_zeros((t.shape[0], n) + tuple(t.shape[2:]))
    take = max(0, min(t.shape[1] - start, n))
    if take:
        out.narrow(1, 0, take).copy_(t.narrow(1, start, take))
    return out


def _pad_caches_to(caches, max_len: int):
    """Pad the prefill caches' KV leaves out to decode capacity (under
    ``kv_seq`` the rank's block of the padded sequence, ``kv_block``);
    recurrent leaves (``conv`` (B, K-1, di) among them) stay as they
    are."""
    seq = kv_split()[0]
    return [[{n: kv_block(t, max_len, seq) if n in KV_KEYS else t
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

    @torch.no_grad()
    def prefill_step(params, batch):
        tokens = batch["tokens"]
        B, S = tokens.shape
        h, caches, _ = forward(cfg, flags, params, batch, "prefill")
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int64,
                                 device=tokens.device)
        h_last = h.gather(1, (lengths - 1).view(B, 1, 1).expand(
            B, 1, h.shape[-1]))
        logits = _logits(cfg, params, h_last[:, 0])
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


@torch.no_grad()
def _decode_one(cfg: ModelConfig, flags: RunFlags, params, state, token,
                rows=None):
    """One decode step: (state, token (B,)) -> (logits (B,V), new_state).
    Like every serving step it runs under ``torch.no_grad``, so a
    trainer's parameters (``requires_grad``) serve as they are. Not
    ``torch.inference_mode``: its outputs could not be updated in place
    outside it, and the engine's slot surgery does that."""
    positions = state["positions"]
    if cfg.engram_layers() and "engram" in params and rows is None:
        idx = decode_engram_indices(cfg.engram, state["last_tokens"], token)
        rows = _engram_rows_all_layers(cfg, flags, params, idx, "decode")
    # int64 once per step: int32 indices would be widened in every layer
    h, new_caches, _ = forward(cfg, flags, params,
                               {"tokens": token[:, None]}, "decode",
                               positions=positions.long(),
                               caches=state["caches"], engram_rows=rows)
    logits = _logits(cfg, params, h[:, 0])
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

    @torch.no_grad()
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

    @torch.no_grad()
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
    @torch.no_grad()
    def encoder_step(params, batch):
        h, _, _ = forward(cfg, flags, params, batch, "train")
        return _logits(cfg, params, h)
    return encoder_step
