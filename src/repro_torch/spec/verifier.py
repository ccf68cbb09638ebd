"""Batched speculative verifier (PyTorch port of ``repro.spec.verifier``).

One call scores a whole proposed block for every slot, computes each
slot's accepted prefix (greedy acceptance: a draft survives iff it equals
the model's own argmax at that position) and rolls the decode state back to
the accepted length per slot (``serving.slots.rollback_state``). Built on
``models.model.build_multitoken_decode``, which unrolls the single-token
decode step, so accepted tokens are bit-identical to sequential greedy
decode. Everything stays on the device: no host read.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models.model import build_multitoken_decode
from ..models.transformer import RunFlags
from ..serving.slots import rollback_state


def accept_lengths(preds: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """Greedy acceptance. ``preds (B, m)``: the model's argmax after each
    block position; ``block (B, m)``: [pending token, drafts...]. Returns
    ``n_accept (B,)`` int64 in [0, m-1]: the longest draft prefix where
    ``preds[:, j-1] == block[:, j]`` (a cumulative product of matches)."""
    if block.shape[1] <= 1:
        return torch.zeros((block.shape[0],), dtype=torch.int64,
                           device=block.device)
    match = (preds[:, :-1] == block[:, 1:]).to(torch.int64)
    return torch.cumprod(match, dim=1).sum(dim=1)


def build_verifier(cfg: ModelConfig, flags: RunFlags,
                   external_rows: bool = False):
    """(params, state, block (B,m) [, rows]) ->
        (preds (B,m), n_accept (B,), next_tok (B,), new_state)

    ``preds[b, :n_accept[b]+1]`` are the tokens the wave emits for slot b
    (the accepted drafts, identical to the model's own greedy choices, plus
    the correction or bonus token); ``next_tok[b] = preds[b, n_accept[b]]``
    is the new pending token; ``new_state`` is rolled back so that only the
    pending token remains unconsumed, as after ``n_accept[b]+1`` sequential
    decode steps."""
    multi = build_multitoken_decode(cfg, flags, external_rows=external_rows)

    def verify(params, state, block, rows=None):
        logits, final_state, snaps = multi(params, state, block, rows) \
            if external_rows else multi(params, state, block)
        preds = torch.argmax(logits, dim=-1)                   # (B, m)
        n_accept = accept_lengths(preds, block)
        # keep the steps that fed [t0, g_1..g_a]; later steps roll back
        new_state = rollback_state(final_state, snaps, n_accept + 1)
        next_tok = torch.gather(preds, 1, n_accept[:, None])[:, 0]
        return preds, n_accept, next_tok, new_state

    if external_rows:
        return lambda params, state, block, rows: verify(params, state,
                                                         block, rows)
    return lambda params, state, block: verify(params, state, block)
