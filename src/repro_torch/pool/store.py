"""Tiered EngramStore: tier latency, prefetch handles and measured stats
(PyTorch port of ``repro.pool.store``).

The store decides what a retrieval *costs* (tier latency, shared-link
queueing when clock-bound); the strategy in ``core/engram.py`` decides
where rows live. The protocol::

    handle = store.prefetch(keys)   # issue the wave's retrieval
    rows   = store.gather(handle)   # materialise the rows
    stats  = store.stats()          # measured counts + stalls

This slice ports ``TierStore`` (one ``TierSpec``) and ``LocalStore``
(weights on the device, no emulated cost) verbatim, and ``TableFetcher``
over the engram_gather kernel (K1). The hot-row cache, tier chain and
fabric raise (ROADMAP queue 1, items 3 and 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..configs.base import EngramConfig
from ..device import upload
from .tiers import TIERS, TierSpec, is_chain


# ---------------------------------------------------------------------------
# segment geometry + key packing
# ---------------------------------------------------------------------------

def segment_bytes(ecfg: EngramConfig) -> int:
    return ecfg.head_dim * 2                       # bf16 rows


def segment_count(ecfg: EngramConfig, batch_tokens: int) -> int:
    return batch_tokens * ecfg.n_tables


def segment_keys(ecfg: EngramConfig, idx, layer_slot: int = 0) -> np.ndarray:
    """Pack table-row indices ``idx (..., T)`` into flat int64 segment keys
    ``(layer_slot * T + t) * table_vocab + row`` — the cache's identity."""
    a = np.asarray(idx, dtype=np.int64)
    T = ecfg.n_tables
    assert a.shape[-1] == T, (a.shape, T)
    tid = np.arange(T, dtype=np.int64) + layer_slot * T
    return (a + tid * ecfg.table_vocab).reshape(-1)


def keys_to_gid(ecfg: EngramConfig, keys: np.ndarray,
                table_rows: Optional[int] = None) -> np.ndarray:
    """Packed segment keys -> flat row ids in one layer's ``(T*V_pad, hd)``
    table space. ``table_rows`` is the table's actual (possibly padded)
    per-table row count; when it equals ``table_vocab`` the whole
    decomposition collapses to one modulo."""
    keys = np.asarray(keys, np.int64)
    V = ecfg.table_vocab if table_rows is None else int(table_rows)
    if V == ecfg.table_vocab:
        return keys % (ecfg.n_tables * ecfg.table_vocab)
    tid = (keys // ecfg.table_vocab) % ecfg.n_tables
    return tid * V + keys % ecfg.table_vocab


# ---------------------------------------------------------------------------
# handles + stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segments:
    """Analytic charge unit: an explicit (hits, misses) split, bypassing
    both token->segment expansion and the cache."""
    hits: int
    misses: int
    shards: Optional[tuple] = None

    @property
    def n(self) -> int:
        return self.hits + self.misses


@dataclasses.dataclass
class PrefetchHandle:
    """An issued (in-flight) retrieval wave."""
    n_segments: int                    # unique segments actually fetched
    latency_s: float                   # store-modelled completion latency
    hits: int = 0
    misses: int = 0
    fetch: Optional[Callable[[], Any]] = None    # materializes the rows
    rows: Any = None
    gathered: bool = False
    wait_s: float = 0.0                # queueing delay on shared links
    issued_at_s: float = 0.0           # virtual issue time (clock-bound)
    reservations: list = dataclasses.field(default_factory=list)
    shards: Optional[tuple] = None     # per-shard split (fabric-backed)


@dataclasses.dataclass
class StoreStats:
    """Measured store-side accounting; the same fields as the reference's,
    so the two compare field by field."""
    tier: str
    cache_tier: Optional[str] = None
    cache_rows: int = 0
    prefetches: int = 0
    gathers: int = 0
    segments: int = 0                  # unique segments fetched
    hits: int = 0
    misses: int = 0
    waves: int = 0                     # scheduler-charged waves
    hidden_waves: int = 0              # waves fully inside the window
    stall_s: float = 0.0               # accumulated overshoot
    retrieval_s: float = 0.0           # accumulated modelled latency
    wait_s: float = 0.0                # queue delay on shared clock links
    spec_waves: int = 0
    spec_tokens: int = 0
    accepted_segments: int = 0
    wasted_segments: int = 0
    spec_depth_sum: float = 0.0
    slot_accepted: dict = dataclasses.field(default_factory=dict)
    slot_wasted: dict = dataclasses.field(default_factory=dict)
    class_bytes: dict = dataclasses.field(default_factory=dict)
    class_busy_s: dict = dataclasses.field(default_factory=dict)
    warm_hits: int = 0
    cold_misses: int = 0
    promotions: int = 0
    demotions: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    @property
    def stall_s_per_wave(self) -> float:
        return self.stall_s / self.waves if self.waves else 0.0


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class _StoreBase:
    """Shared prefetch/gather bookkeeping; subclasses define the latency.

    A store may be *clock-bound*: ``bind_cursor`` attaches the owning
    replica's ``serving/clock.py`` cursor, and the subclass registers the
    shared ``Link`` its transfers occupy; a charged wave then adds the
    link's queueing delay to its modelled latency. Unbound stores
    (``clock=None``) are the pure tier model, zero wait."""

    def __init__(self, ecfg: EngramConfig, tier_name: str):
        self.ecfg = ecfg
        self._stats = StoreStats(tier=tier_name)
        self.cursor = None

    def bind_cursor(self, cursor) -> None:
        """Attach the owning replica's timeline cursor (serving/clock.py)."""
        self.cursor = cursor

    # latency model -----------------------------------------------------
    def latency_for_segments(self, n_segments: int) -> float:
        raise NotImplementedError

    def occupancy_s(self, n_segments: int) -> float:
        """Shared-medium occupancy of a wave (what a clock link books);
        0 for stores with no shared resource."""
        return 0.0

    def read_latency_s(self, batch_tokens: int) -> float:
        """Analytic read latency for a full (uncached) token batch."""
        return self.latency_for_segments(segment_count(self.ecfg, batch_tokens))

    # protocol ----------------------------------------------------------
    def _classify(self, tokens) -> tuple[int, int, int]:
        """-> (n_segments, hits, misses) for a wave. A key array counts
        *unique* keys; a bare token count keeps the paper's raw
        B-discrete-reads convention; ``Segments`` pins an explicit split."""
        if isinstance(tokens, Segments):
            return tokens.n, tokens.hits, tokens.misses
        if np.isscalar(tokens) or isinstance(tokens, int):
            n = segment_count(self.ecfg, int(tokens))
        else:
            n = int(np.unique(np.asarray(tokens, dtype=np.int64)).size)
        return n, 0, n

    def prefetch(self, tokens, fetch: Optional[Callable[[], Any]] = None
                 ) -> PrefetchHandle:
        n, hits, misses = self._classify(tokens)
        lat, wait, resv = self._charged_latency(hits, misses)
        h = PrefetchHandle(n_segments=n, latency_s=lat, hits=hits,
                           misses=misses, fetch=fetch, wait_s=wait,
                           issued_at_s=self.cursor.now_s if self.cursor
                           is not None else 0.0,
                           reservations=resv)
        s = self._stats
        s.prefetches += 1
        s.segments += n
        s.hits += hits
        s.misses += misses
        s.retrieval_s += lat
        s.wait_s += wait
        return h

    def _split_latency(self, hits: int, misses: int) -> float:
        return self.latency_for_segments(hits + misses)

    def _charged_latency(self, hits: int, misses: int
                         ) -> tuple[float, float, list]:
        """Modelled latency + shared-link queue wait for one wave ->
        (latency incl. wait, wait alone, link reservations)."""
        lat = self._split_latency(hits, misses)
        wait, resv = self._reserve(hits + misses)
        return lat + wait, wait, resv

    def note_class(self, klass: str, nbytes: int, busy_s: float) -> None:
        """Attribute ``nbytes`` / ``busy_s`` of shared-medium occupancy to
        a traffic class (per-class split in ``StoreStats``)."""
        s = self._stats
        s.class_bytes[klass] = s.class_bytes.get(klass, 0) + int(nbytes)
        s.class_busy_s[klass] = s.class_busy_s.get(klass, 0.0) + busy_s

    def _reserve(self, n_segments: int) -> tuple[float, list]:
        link = getattr(self, "_link", None)
        if link is None or self.cursor is None or n_segments <= 0:
            return 0.0, []
        occ = self.occupancy_s(n_segments)
        nbytes = n_segments * segment_bytes(self.ecfg)
        wait, tr = link.reserve(self.cursor.now_s, occ, nbytes=nbytes,
                                wave=self.cursor.wave_tag(), klass="engram")
        self.note_class("engram", nbytes, occ)
        return wait, [tr]

    def gather(self, handle: PrefetchHandle) -> Any:
        if not handle.gathered:
            if handle.fetch is not None:
                handle.rows = handle.fetch()
            handle.gathered = True
            self._stats.gathers += 1
        return handle.rows

    def note_wave(self, stall_s: float, hidden: bool) -> None:
        s = self._stats
        s.waves += 1
        s.stall_s += stall_s
        s.hidden_waves += int(hidden)

    def stats(self) -> StoreStats:
        return self._stats

    def reset_stats(self) -> None:
        old = self._stats
        self._stats = StoreStats(tier=old.tier, cache_tier=old.cache_tier,
                                 cache_rows=old.cache_rows)


class TierStore(_StoreBase):
    """Engram rows resident in one memory tier of the paper's fabric.

    ``clock``: bind the tier's shared medium as a fleet-wide ``Link``
    (keyed by tier name, so every replica's TierStore on the same clock
    contends on one budget)."""

    def __init__(self, ecfg: EngramConfig, tier: TierSpec | str, clock=None):
        tier = TIERS[tier] if isinstance(tier, str) else tier
        super().__init__(ecfg, tier.name)
        self.tier = tier
        self._link = clock.link(f"tier:{tier.name}", tier.bandwidth_Bps) \
            if clock is not None else None

    def latency_for_segments(self, n_segments: int) -> float:
        if n_segments <= 0:
            return 0.0
        return self.tier.read_latency_s(n_segments, segment_bytes(self.ecfg))

    def occupancy_s(self, n_segments: int) -> float:
        return self.tier.service_s(n_segments, segment_bytes(self.ecfg))


class LocalStore(_StoreBase):
    """Rows co-resident with the activations (device HBM / local weights):
    the retrieval is part of the forward pass, no emulated pool cost."""

    def __init__(self, ecfg: EngramConfig):
        super().__init__(ecfg, "local")

    def latency_for_segments(self, n_segments: int) -> float:
        return 0.0


# ---------------------------------------------------------------------------
# row materialization through the engram_gather kernel (K1)
# ---------------------------------------------------------------------------

class TableFetcher:
    """Materialises rows for packed segment keys from one layer's Engram
    tables ``(T, V_pad, hd)``, through the engram_gather kernel (its plain
    version for a table on the CPU).

    Row ids come from ``keys_to_gid(..., table_rows=V_pad)``: the tables
    are padded past ``table_vocab``, so ``key % (T * table_vocab)`` would
    address the wrong rows. A wave's ids are computed and range-checked on
    the host and moved to the device once."""

    def __init__(self, ecfg: EngramConfig, tables: torch.Tensor):
        self.ecfg = ecfg
        self.T, self.V, self.hd = tables.shape
        self.flat = tables.view(self.T * self.V, self.hd)   # no copy

    def gid_for(self, keys) -> np.ndarray:
        """Flat row ids in this fetcher's (padded) table space."""
        return keys_to_gid(self.ecfg, keys, table_rows=self.V).reshape(-1)

    def __call__(self, keys=None, *, gid=None) -> torch.Tensor:
        """Gather rows (N, hd) by packed ``keys`` or precomputed ``gid``."""
        from ..kernels.engram_gather import gather_rows
        if gid is None:
            gid = self.gid_for(keys)
        gid = np.asarray(gid, np.int64)
        if gid.size and (gid.min() < 0 or gid.max() >= self.flat.shape[0]):
            raise IndexError(f"row id outside the {self.flat.shape[0]}-row "
                             "table")
        return gather_rows(self.flat, upload(gid, self.flat.device))


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

def make_store(ecfg: EngramConfig, tier: TierSpec | str | None,
               store_cfg=None, clock=None):
    """The store for a backing tier (``None`` -> ``LocalStore``)."""
    scfg = store_cfg if store_cfg is not None else ecfg.store
    if tier is not None and is_chain(tier):
        raise NotImplementedError("tier chains (pool='CXL+SSD'): ROADMAP "
                                  "queue 1, item 6 (tierchain.py)")
    if scfg is not None and scfg.cache_rows > 0:
        raise NotImplementedError("the hot-row cache (cache_rows > 0): "
                                  "ROADMAP queue 1, item 3 (CachedStore)")
    if tier is None:
        return LocalStore(ecfg)
    return TierStore(ecfg, tier, clock=clock)
