"""Draft-token proposers for speculative decoding (PyTorch port of
``repro.spec.proposer``).

A proposer guesses the next ``k`` tokens of a slot from its visible
context. Correctness never depends on proposal quality (the verifier
accepts exactly the greedy continuation), so proposers only trade
acceptance rate (deeper realized prefetch windows) against proposal cost:

  * ``NGramProposer``      suffix cache over the engine's own emitted
                           streams: host only, no weights, high acceptance
                           on repetitive traffic.
  * ``DraftModelProposer`` a shrunken config run through the port's own
                           prefill and decode steps on the device;
                           stateless across waves (it re-prefills a short
                           context window per proposal), so it needs no
                           draft-side rollback.
  * ``ScriptedProposer`` / ``ConstantProposer``  test and bench harness
                           proposers pinning acceptance to 100 % / ~0 %.

Pipelining contract (``SpecConfig.pipeline``): the engine also calls
``propose`` with *optimistic* contexts (the current stream extended by
not-yet-verified drafts) while the verify pass is in flight. ``propose``
must therefore be read-only: ingestion happens only through
``begin``/``observe``, which the engine feeds verified streams.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from ..configs.base import ModelConfig, SpecConfig
from ..device import resolve_device, sync_allowed, upload


@runtime_checkable
class Proposer(Protocol):
    def begin(self, slot: int, context: Sequence[int]) -> None:
        """A request entered ``slot``; ``context`` is its prompt (+ first
        token)."""
        ...

    def observe(self, slot: int, context: Sequence[int]) -> None:
        """``context`` is the slot's full visible stream after a wave."""
        ...

    def propose(self, slot: int, context: Sequence[int],
                k: int) -> list[int]:
        """Draft the next ``k`` tokens after ``context`` (always length k:
        pad with a guess; bad guesses are rejected, not wrong). Must be
        read-only (see the module docstring)."""
        ...

    def end(self, slot: int) -> None:
        """The slot's request finished."""
        ...


class _ProposerBase:
    def begin(self, slot: int, context: Sequence[int]) -> None:
        pass

    def observe(self, slot: int, context: Sequence[int]) -> None:
        pass

    def end(self, slot: int) -> None:
        pass


class NGramProposer(_ProposerBase):
    """Suffix-cache proposer: longest-match n-gram lookup over every stream
    the engine has emitted (one global table: repeated requests teach it
    the exact greedy continuation, so replays verify at ~100 %)."""

    MAX_ENTRIES = 1_000_000                      # bound on stored suffixes

    def __init__(self, order: int = 4):
        if order < 2:
            raise ValueError(f"NGramProposer order must be >= 2, got {order}")
        self.order = order                       # suffix lengths 1..order-1
        self._tables: list[dict] = [dict() for _ in range(order - 1)]
        self._seen: dict[int, int] = {}          # slot -> ingested length
        self.pruned = 0

    def begin(self, slot: int, context: Sequence[int]) -> None:
        self._seen[slot] = 0
        self.observe(slot, context)

    def observe(self, slot: int, context: Sequence[int]) -> None:
        ctx = list(context)
        start = max(self._seen.get(slot, 0), 1)
        for i in range(start, len(ctx)):
            nxt = ctx[i]
            for n in range(1, self.order):
                if i - n < 0:
                    break
                key = tuple(ctx[i - n:i])
                bucket = self._tables[n - 1].setdefault(key, {})
                bucket[nxt] = bucket.get(nxt, 0) + 1
        self._seen[slot] = len(ctx)
        self._maybe_prune()

    def _maybe_prune(self) -> None:
        """Bound memory for a long-lived engine: past ``MAX_ENTRIES``
        suffixes, drop once-seen entries first, then clear the largest
        table (the cheapest to relearn)."""
        if sum(len(t) for t in self._tables) <= self.MAX_ENTRIES:
            return
        for t in self._tables:
            stale = [key for key, b in t.items()
                     if len(b) == 1 and max(b.values()) <= 1]
            for key in stale:
                del t[key]
                self.pruned += 1
        while sum(len(t) for t in self._tables) > self.MAX_ENTRIES:
            longest = max(self._tables, key=len)
            self.pruned += len(longest)
            longest.clear()

    def end(self, slot: int) -> None:
        self._seen.pop(slot, None)

    def _next(self, ctx: list[int]):
        for n in range(self.order - 1, 0, -1):   # longest suffix first
            if len(ctx) < n:
                continue
            bucket = self._tables[n - 1].get(tuple(ctx[-n:]))
            if bucket:
                # deterministic: max count, then smallest token id
                return max(bucket.items(), key=lambda kv: (kv[1], -kv[0]))[0]
        return None

    def propose(self, slot: int, context: Sequence[int],
                k: int) -> list[int]:
        ctx = list(context)
        out = []
        for _ in range(k):
            t = self._next(ctx)
            if t is None:
                t = ctx[-1] if ctx else 0        # repeat-last fallback
            out.append(int(t))
            ctx.append(int(t))
        return out


def draft_config(cfg: ModelConfig, spec: SpecConfig) -> ModelConfig:
    """Shrink ``cfg`` to its first ``spec.draft_layers`` layers for the
    draft model: the same vocabulary and width, no Engram (drafts stay off
    the pool's hot path)."""
    d = max(1, min(spec.draft_layers, cfg.n_layers))
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-draft", n_layers=d,
        layer_types=cfg.layer_types[:d], attn_kinds=cfg.attn_kinds[:d],
        ffn_types=cfg.ffn_types[:d], engram=None, spec=None)


class DraftModelProposer(_ProposerBase):
    """Small draft model on a shrunken config, run through the port's
    ``build_prefill_step``/``build_decode_step`` on ``device`` (the card
    unless the caller passes ``device="cpu"``). Each proposal re-prefills
    the last ``draft_context`` tokens, decodes k - 1 greedy continuations
    on the device and reads the whole (1, k) draft in ONE device->host
    read, counted in ``reads`` (a real sync, made with PyTorch's sync debug
    mode suspended; not an ``EngineStats.d2h_pulls`` read).

    ``params``: the draft model's tree on ``device`` (default: seeded
    ``init_params`` of the draft config)."""

    def __init__(self, cfg: ModelConfig, spec: SpecConfig, *, flags=None,
                 seed: int = 0, params=None, device=None):
        from ..models.layers import with_f32_head
        from ..models.model import (build_decode_step, build_prefill_step,
                                    init_params)
        from ..models.transformer import RunFlags
        self.cfg = draft_config(cfg, spec)
        self.device = resolve_device(device)
        self.ctx_len = max(4, int(spec.draft_context))
        flags = flags if flags is not None else RunFlags()
        if params is None:
            params = init_params(self.cfg, seed, self.device)
        if params["embed"]["w"].device.type != self.device.type:
            raise ValueError(f"draft params live on "
                             f"{params['embed']['w'].device}, the proposer "
                             f"runs on {self.device}")
        self.params = with_f32_head(params)
        self._prefill = build_prefill_step(
            self.cfg, flags, max_len=self.ctx_len + spec.max_draft + 1)
        self._decode = build_decode_step(self.cfg, flags)
        self.reads = 0

    def propose(self, slot: int, context: Sequence[int],
                k: int) -> list[int]:
        ctx = list(context)[-self.ctx_len:]
        if not ctx or k <= 0:
            return [0] * k
        toks = np.zeros((1, self.ctx_len), np.int64)
        toks[0, :len(ctx)] = ctx
        batch = {"tokens": upload(toks, self.device),
                 "lengths": upload(np.asarray([len(ctx)], np.int64),
                                   self.device)}
        logits, state = self._prefill(self.params, batch)
        out = [torch.argmax(logits, dim=-1)]                     # (1,)
        for _ in range(k - 1):
            logits, state = self._decode(self.params, state, out[-1])
            out.append(torch.argmax(logits, dim=-1))
        draft = torch.stack(out, dim=1)[0]                       # (k,)
        self.reads += 1
        with sync_allowed(self.device):                          # ONE read
            return [int(t) for t in draft.cpu().numpy()]


class ScriptedProposer(_ProposerBase):
    """Oracle proposer for tests and benches: given the full expected
    stream per request (prompt + greedy continuation), proposes exactly the
    next k tokens: 100 % acceptance when the script matches the model."""

    def __init__(self, streams: Sequence[Sequence[int]]):
        self.streams = [list(s) for s in streams]

    def propose(self, slot: int, context: Sequence[int],
                k: int) -> list[int]:
        ctx = list(context)
        for s in self.streams:
            if len(s) >= len(ctx) and s[:len(ctx)] == ctx:
                tail = s[len(ctx):len(ctx) + k]
                return tail + [0] * (k - len(tail))
        return [0] * k


class ConstantProposer(_ProposerBase):
    """Adversarial proposer for tests: always drafts ``token``, pinning
    acceptance to ~0 % (unless the model really does emit it)."""

    def __init__(self, token: int = 0):
        self.token = int(token)

    def propose(self, slot: int, context: Sequence[int],
                k: int) -> list[int]:
        return [self.token] * k


def make_proposer(cfg: ModelConfig, spec: SpecConfig, *, flags=None,
                  seed: int = 0, device=None) -> Proposer:
    if spec.proposer == "ngram":
        return NGramProposer(order=spec.ngram_order)
    if spec.proposer == "draft":
        return DraftModelProposer(cfg, spec, flags=flags, seed=seed + 1,
                                  device=device)
    raise ValueError(f"unknown proposer {spec.proposer!r}")
