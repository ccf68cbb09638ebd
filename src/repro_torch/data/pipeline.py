"""Deterministic synthetic token pipeline, a zipf n-gram mixture (PyTorch
port of ``repro.data.pipeline``).

The generator produces text with recurring n-grams so Engram lookups are
meaningful: the next token is drawn from a deterministic successor table
with probability ``ngram_p`` (the "static knowledge" the Engram tables can
memorise) and from a Zipf unigram distribution otherwise.

Everything is host-side numpy and deterministic in (seed, step, shard), as
in the reference, and bit for bit the reference's batches: restarting from
a checkpoint at step k regenerates the exact batch stream. Only
``shard_batch`` touches torch, to put a batch on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig
from ..device import resolve_device, upload


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int                     # global batch
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2            # unigram skew
    ngram_p: float = 0.55          # P(next token from successor table)
    n_hot: int = 4096              # tokens participating in successor chains
    shard_id: int = 0              # data-parallel shard
    n_shards: int = 1

    @property
    def local_batch(self) -> int:
        if self.batch % self.n_shards:
            raise ValueError(f"batch {self.batch} over {self.n_shards} "
                             "shards")
        return self.batch // self.n_shards


def _successors(dc: DataConfig) -> np.ndarray:
    """Deterministic bigram successor table over the 'hot' vocabulary."""
    rng = np.random.RandomState(dc.seed ^ 0xA5A5)
    hot = min(dc.n_hot, dc.vocab_size)
    return rng.randint(0, dc.vocab_size, size=hot).astype(np.int32)


def _zipf_probs(dc: DataConfig) -> np.ndarray:
    ranks = np.arange(1, dc.vocab_size + 1, dtype=np.float64)
    p = ranks ** (-dc.zipf_a)
    return p / p.sum()


class TokenPipeline:
    """Batches of {tokens, labels}, int32 (local_batch, seq_len) numpy."""

    def __init__(self, dc: DataConfig):
        self.dc = dc
        self.succ = _successors(dc)
        self.zipf = _zipf_probs(dc)
        self._hot = self.succ.shape[0]

    def batch_at(self, step: int) -> dict:
        dc = self.dc
        rng = np.random.Generator(np.random.Philox(
            key=dc.seed, counter=[step, dc.shard_id, 0, 0]))
        B, S = dc.local_batch, dc.seq_len
        # +1 so labels are the shifted stream
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(dc.vocab_size, size=B, p=self.zipf)
        use_ngram = rng.random((B, S)) < dc.ngram_p
        fresh = rng.choice(dc.vocab_size, size=(B, S), p=self.zipf)
        for t in range(S):
            prev = toks[:, t]
            chained = self.succ[prev % self._hot]
            toks[:, t + 1] = np.where(use_ngram[:, t] & (prev < dc.vocab_size),
                                      chained, fresh[:, t])
        return {"tokens": toks[:, :-1].copy(),
                "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def frontend_features(cfg: ModelConfig, tokens: np.ndarray,
                      seed: int = 0) -> dict:
    """The stub frontends' batch entries, deterministic in the seed: audio
    ``frames`` (B, S, frontend_dim) or vision ``patches`` (B, P,
    frontend_dim), f32."""
    out = {}
    if cfg.frontend == "audio":
        B, S = tokens.shape
        rng = np.random.Generator(np.random.Philox(key=seed ^ 0xF00D))
        out["frames"] = rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)
    elif cfg.frontend == "vision":
        B = tokens.shape[0]
        rng = np.random.Generator(np.random.Philox(key=seed ^ 0xBEEF))
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patch_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def make_batch(cfg: ModelConfig, dc: DataConfig, step: int,
               pipeline: Optional[TokenPipeline] = None) -> dict:
    """One full batch for ``cfg`` including the frontend stubs."""
    pipe = pipeline or TokenPipeline(dc)
    b = pipe.batch_at(step)
    b.update(frontend_features(cfg, b["tokens"], dc.seed))
    return b


def shard_batch(batch: dict, ctx=None, device=None) -> dict:
    """Host numpy batch -> tensors on ``device`` (default the card;
    ``upload``). Under a sharding context each rank keeps its block of the
    batch axis (``ShardCtx.block``), as the reference places the batch
    sharded along it."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = upload(v, dev)
        if ctx is not None:
            t = ctx.block(t, ("batch",) + (None,) * (t.ndim - 1))
        out[k] = t
    return out
