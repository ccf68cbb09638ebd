"""Tiered EngramStore: tier latency, prefetch handles and measured stats
(PyTorch port of ``repro.pool.store``).

The store decides what a retrieval *costs* (tier latency, shared-link
queueing when clock-bound); the strategy in ``core/engram.py`` decides
where rows live. The protocol::

    handle = store.prefetch(keys)   # issue the wave's retrieval
    rows   = store.gather(handle)   # materialise the rows
    stats  = store.stats()          # measured counts + stalls

The port has ``TierStore`` (one ``TierSpec``), ``LocalStore`` (weights
on the device, no emulated cost), ``CachedStore`` (an LRU hot-row cache,
``pool/cache.py``, in front of a ``TierStore`` or a ``FabricStore``: the
measured hit/miss split of each wave enters the latency model), the
three-level ``TierChain`` (``pool/tierchain.py``, ``pool="CXL+SSD"``) and
``FabricStore`` (``pool/fabric.py``, the pool sharded over M nodes). All
of them change only the cost model: rows are still materialised by
``TableFetcher`` over the engram_gather kernel (K1), with
``fetch_layers`` gathering every Engram layer's rows of a wave in one
launch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..configs.base import EngramConfig
from ..device import upload
from .cache import LRUHotRowCache, TinyLFUAdmission, WaveAccess
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

    @property
    def spec_window_steps(self) -> float:
        """Prefetch window depth in emitted-token decode steps, as the
        cost model prices it from the step estimate: the lead time of the
        deepest *accepted* position between prefetch issue and
        consumption, averaged over speculative waves. Driven by
        verified acceptance: all-rejected waves collapse it below one
        step."""
        return self.spec_depth_sum / self.spec_waves if self.spec_waves \
            else 0.0

    @property
    def wasted_prefetch_rate(self) -> float:
        n = self.accepted_segments + self.wasted_segments
        return self.wasted_segments / n if n else 0.0


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

    def reserve_prefetch(self, n_segments: int):
        """Book a future wave's occupancy on the shared medium now (a
        chunk wave books the next chunk's rows). Returns the ``Transfer``,
        or None when unbound; the engine refunds it at the next wave,
        where the real keys are charged, or on a mid-prefill cancel."""
        link = getattr(self, "_link", None)
        if link is None or self.cursor is None or n_segments <= 0:
            return None
        _, tr = link.reserve(self.cursor.now_s,
                             self.occupancy_s(n_segments),
                             nbytes=n_segments * segment_bytes(self.ecfg))
        return tr

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

    def note_spec_wave(self, stall_s: float, hidden: bool, tokens: int,
                       depth_steps: float, accepted_segments: int,
                       wasted_segments: int, per_slot=None) -> None:
        """Account one verified speculative wave: ``tokens`` were emitted,
        its deepest accepted position had ``depth_steps`` of measured
        lookahead, and the prefetched segments split into used and
        mis-speculated (fetched for a rejected draft). ``per_slot``:
        optional ``{slot: (accepted_segments, wasted_segments)}``."""
        self.note_wave(stall_s, hidden)
        s = self._stats
        s.spec_waves += 1
        s.spec_tokens += int(tokens)
        s.spec_depth_sum += float(depth_steps)
        s.accepted_segments += int(accepted_segments)
        s.wasted_segments += int(wasted_segments)
        if per_slot:
            for slot, (acc, waste) in per_slot.items():
                s.slot_accepted[slot] = s.slot_accepted.get(slot, 0) + int(acc)
                s.slot_wasted[slot] = s.slot_wasted.get(slot, 0) + int(waste)

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


class CachedStore(_StoreBase):
    """LRU hot-row cache (``cache_tier``) in front of a backing store (a
    ``TierStore``, or a ``FabricStore`` whose fabric charges the misses).

    Hit and miss paths proceed in parallel, so a wave completes at
    ``max(hit path, miss path)``: the §6 formula evaluated with the
    measured per-wave split. Clock-bound, the two paths occupy two links:
    misses the backing tier's fleet-wide link, hits the cache's own DRAM
    channel: ``cache_link`` when given (a shared cache hands every replica
    the same link, so N replicas hitting it split its bandwidth), else a
    private ``cache:<id>`` link at the cache tier's bandwidth."""

    def __init__(self, backing, cache_tier: TierSpec | str = "DRAM",
                 cache: Optional[LRUHotRowCache] = None, clock=None,
                 cache_link=None):
        super().__init__(backing.ecfg, backing.tier.name)
        self.backing = backing
        self.cache_tier = TIERS[cache_tier] if isinstance(cache_tier, str) \
            else cache_tier
        self.cache = cache
        if cache_link is not None:
            self._cache_link = cache_link
        elif clock is not None:
            self._cache_link = clock.link(f"cache:{id(self):x}",
                                          self.cache_tier.bandwidth_Bps)
        else:
            self._cache_link = None
        self._stats.cache_tier = self.cache_tier.name
        # the cache defines __len__: test identity, not truthiness
        self._stats.cache_rows = 0 if cache is None else cache.capacity_rows

    def bind_cursor(self, cursor) -> None:
        super().bind_cursor(cursor)
        self.backing.bind_cursor(cursor)

    def latency_for_segments(self, n_segments: int) -> float:
        return self.backing.latency_for_segments(n_segments)

    def occupancy_s(self, n_segments: int) -> float:
        # pre-reservations assume the miss path (the backing medium)
        return self.backing.occupancy_s(n_segments)

    def reserve_prefetch(self, n_segments: int):
        return self.backing.reserve_prefetch(n_segments)

    def _split_latency(self, hits: int, misses: int) -> float:
        seg = segment_bytes(self.ecfg)
        t_hit = self.cache_tier.read_latency_s(hits, seg) if hits else 0.0
        return max(t_hit, self.backing.latency_for_segments(misses))

    def _charged_latency(self, hits: int, misses: int
                         ) -> tuple[float, float, list]:
        seg = segment_bytes(self.ecfg)
        resv = []
        t_hit = self.cache_tier.read_latency_s(hits, seg) if hits else 0.0
        w_hit = w_miss = 0.0
        charge_misses = getattr(self.backing, "charge_misses", None)
        if charge_misses is not None:
            # fabric-backed: the miss wave fans out per shard (node links
            # and switch), charged by the fabric itself
            miss_path, w_miss, trs = charge_misses(misses)
            resv.extend(trs)
        else:
            link = self.backing._link
            if misses and self.cursor is not None and link is not None:
                occ = self.backing.occupancy_s(misses)
                w_miss, tr = link.reserve(self.cursor.now_s, occ,
                                          nbytes=misses * seg,
                                          wave=self.cursor.wave_tag(),
                                          klass="engram")
                self.note_class("engram", misses * seg, occ)
                resv.append(tr)
            miss_path = self.backing.latency_for_segments(misses) + w_miss
        if hits and self.cursor is not None and self._cache_link is not None:
            w_hit, tr = self._cache_link.reserve(
                self.cursor.now_s, self.cache_tier.service_s(hits, seg),
                nbytes=hits * seg, wave=self.cursor.wave_tag())
            resv.append(tr)
        return max(t_hit + w_hit, miss_path), max(w_hit, w_miss), resv

    def ideal_latency_s(self, batch_tokens: int, hit_rate: float) -> float:
        """Analytic mode (the §6 formula): an assumed ``hit_rate`` instead
        of the LRU's measured split."""
        n = segment_count(self.ecfg, batch_tokens)
        hits = int(round(n * hit_rate))
        return self._split_latency(hits, n - hits)

    def _classify(self, tokens) -> tuple[int, int, int]:
        if (isinstance(tokens, Segments) or np.isscalar(tokens)
                or isinstance(tokens, int) or self.cache is None):
            return super()._classify(tokens)
        wave: WaveAccess = self.cache.access_wave(tokens)
        return wave.n_segments, wave.hits, wave.misses


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
        if gid is None:
            gid = self.gid_for(keys)
        return fetch_layers([self], [gid])[0]


def fetch_layers(fetchers, gids) -> torch.Tensor:
    """Every Engram layer's rows in ONE engram_gather launch: ``gids[j]``
    are flat row ids in ``fetchers[j]``'s table space, all of one length N
    -> (L, N, hd). The ids are range-checked on the host and uploaded in
    one copy."""
    from ..kernels.engram_gather import gather_rows_multi
    gid = np.stack([np.asarray(g, np.int64).reshape(-1) for g in gids])
    for f, g in zip(fetchers, gid):
        rows = f.flat.shape[0]
        if g.size and (g.min() < 0 or g.max() >= rows):
            raise IndexError(f"row id outside the {rows}-row table")
    dev = fetchers[0].flat.device
    return gather_rows_multi([f.flat for f in fetchers], upload(gid, dev))


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

def make_store(ecfg: EngramConfig, tier: TierSpec | str | None,
               store_cfg=None, cache=None, clock=None, cache_link=None,
               fabric=None):
    """The store for a backing tier (``None`` and no fabric ->
    ``LocalStore``), honouring the store config: a chain spec
    (``"CXL+SSD"``) builds a ``TierChain`` (its warm level sharded over
    ``fabric`` when one is given); otherwise ``fabric`` (a ``PoolFabric``)
    backs the store instead of a single-link ``TierStore``, and
    ``cache_rows > 0`` puts a ``CachedStore`` with ``"lru"`` or
    ``"tinylfu"`` admission in front.

    ``cache``: an externally owned hot-row cache (a ``SharedCache.view``
    shared across engine replicas) mounted instead of a private LRU.
    ``cache_link``: the clock link its hits contend on (the router passes
    one link for a shared cache); without it each store owns a private
    cache link."""
    scfg = store_cfg if store_cfg is not None else ecfg.store
    if tier is not None and is_chain(tier):
        from .tierchain import TierChain
        if cache is not None:
            raise ValueError("a shared hot-row cache cannot front a tier "
                             "chain: the chain owns its DRAM front")
        return TierChain(ecfg, tier, store_cfg=scfg, clock=clock,
                         fabric=fabric)
    if tier is None and fabric is None:
        return LocalStore(ecfg)
    if fabric is not None:
        from .fabric import FabricStore
        base = FabricStore(ecfg, fabric)
    else:
        base = TierStore(ecfg, tier, clock=clock)
    if cache is not None:
        tier_name = scfg.cache_tier if scfg is not None else "DRAM"
        return CachedStore(base, cache_tier=tier_name, cache=cache,
                           clock=clock, cache_link=cache_link)
    if scfg is not None and scfg.cache_rows > 0:
        if scfg.admission not in ("lru", "tinylfu"):
            raise ValueError(f"unknown cache admission {scfg.admission!r}")
        adm = TinyLFUAdmission() if scfg.admission == "tinylfu" else None
        return CachedStore(base, cache_tier=scfg.cache_tier,
                           cache=LRUHotRowCache(scfg.cache_rows,
                                                admission=adm),
                           clock=clock, cache_link=cache_link)
    return base
