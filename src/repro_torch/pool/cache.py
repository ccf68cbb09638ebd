"""Hot-row cache for Engram segments and the prefix KV cache (PyTorch port
of ``repro.pool.cache``; host-side numpy, as in the reference).

``LRUHotRowCache`` is the paper's §6 rescue measured on the serving path:
an LRU over packed (layer, table, row) segment keys that the engine feeds
with each wave's real key stream, so the hit rate entering the store's
latency model is observed, not assumed. A wave counts *unique* keys: a
duplicate of an in-wave miss rides the same fetch and is neither a hit
nor another miss. ``TinyLFUAdmission`` (a ``FrequencySketch``) keeps a
one-shot scan from flushing the hot set. ``occupy`` lands preempted KV
pages in the cache as capacity pressure, outside the hit/miss counts;
the sketch's virtual-clock ``decay`` ages the tier chain's placement.

``PrefixKVCache`` is chunked prefill's reuse layer: a byte-budget LRU of
chunk-boundary slot snapshots (``serving.slots.extract_prefix``) keyed by
chained prefix-block hashes (``core.hashing.prefix_chain_keys``).

``SharedCache`` and ``PrefixKVCache.view`` are the fleet's: several engine
replicas (``serving.router.Router``) mount one cache through per-replica
views, so a row or prefix one replica fetched is a hit for every other.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np


@dataclasses.dataclass
class WaveAccess:
    """Per-wave cache accounting (unique-key granularity)."""
    hits: int
    misses: int

    @property
    def n_segments(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.n_segments
        return self.hits / n if n else 0.0


class FrequencySketch:
    """Count-min sketch with saturating counters and periodic halving (the
    TinyLFU aging scheme): how often a key was seen, without per-key
    state, at the reference's default sizes.

    ``decay_half_life_s``: virtual-clock aging (the tier chain's promotion
    sketch): ``decay(now_s)`` halves every count once per whole half-life
    of clock time since the last decay, so a workload shift re-ranks the
    hot set. None keeps the op-count halving only (which stays on either
    way, as saturation protection)."""

    WIDTH = 1 << 15                 # columns per row (a power of two)
    DEPTH = 4
    MAX_COUNT = 15
    SAMPLE_LIMIT = 16 * WIDTH       # observations between halvings

    def __init__(self, decay_half_life_s: float | None = None):
        self._table = np.zeros((self.DEPTH, self.WIDTH), np.uint8)
        self._seeds = np.asarray(
            [0x9E3779B97F4A7C15 * (i + 1) & 0xFFFFFFFFFFFFFFFF
             for i in range(self.DEPTH)], np.uint64)
        self._ops = 0
        self.decay_half_life_s = decay_half_life_s
        self._last_decay_s = 0.0

    def decay(self, now_s: float) -> int:
        """Age the counts up to clock time ``now_s``: one halving per whole
        half-life elapsed since the last decay. Returns the halvings
        applied (0 with aging off). Deterministic in ``now_s``."""
        hl = self.decay_half_life_s
        if hl is None or hl <= 0.0:
            return 0
        steps = 0
        while now_s - self._last_decay_s >= hl:
            self._table >>= 1
            self._ops //= 2
            self._last_decay_s += hl
            steps += 1
        return steps

    def _slots(self, keys: np.ndarray) -> np.ndarray:
        """(depth, n) table columns for each key."""
        k = keys.astype(np.uint64)[None, :] ^ self._seeds[:, None]
        k ^= k >> np.uint64(33)
        k *= np.uint64(0xFF51AFD7ED558CCD)
        k ^= k >> np.uint64(33)
        return (k & np.uint64(self.WIDTH - 1)).astype(np.int64)

    def observe(self, keys) -> None:
        keys = np.asarray(keys, np.int64)
        if keys.size == 0:
            return
        slots = self._slots(keys)
        for d in range(self.DEPTH):
            # colliding keys of one wave add their counts together
            cols, counts = np.unique(slots[d], return_counts=True)
            row = self._table[d]
            row[cols] = np.minimum(row[cols].astype(np.int64) + counts,
                                   self.MAX_COUNT).astype(np.uint8)
        self._ops += int(keys.size)
        if self._ops >= self.SAMPLE_LIMIT:         # aging: halve everything
            self._table >>= 1
            self._ops //= 2

    def estimate(self, keys) -> np.ndarray:
        keys = np.asarray(keys, np.int64)
        if keys.size == 0:
            return np.zeros(0, np.int64)
        slots = self._slots(keys)
        est = self._table[0][slots[0]].astype(np.int64)
        for d in range(1, self.DEPTH):
            est = np.minimum(est, self._table[d][slots[d]])
        return est


class TinyLFUAdmission:
    """A missed key is admitted only if the sketch estimates it at least as
    hot as the LRU victim it would displace."""

    def __init__(self):
        self.sketch = FrequencySketch()
        self.rejected = 0

    def observe(self, keys) -> None:
        self.sketch.observe(keys)

    def admit(self, candidate: int, victim: int) -> bool:
        cand, vic = self.sketch.estimate([candidate, victim])
        ok = bool(cand >= vic)
        if not ok:
            self.rejected += 1
        return ok


class LRUHotRowCache:
    """Fixed-capacity LRU over int row keys.

    ``access_wave(keys)`` is one wave's transaction: classify each unique
    key as hit or miss, move hits to most-recent, insert misses (evicting
    the least-recent rows past capacity) and add to the running totals.
    ``admission`` (e.g. ``TinyLFUAdmission``) gates inserts once the cache
    is full: a miss is always counted, but cached only if admitted."""

    def __init__(self, capacity_rows: int, admission=None):
        if capacity_rows <= 0:
            raise ValueError(f"capacity_rows must be positive, got "
                             f"{capacity_rows}")
        self.capacity_rows = int(capacity_rows)
        self.admission = admission
        self._rows: OrderedDict[int, None] = OrderedDict()
        self.total_hits = 0
        self.total_misses = 0
        self.waves = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._rows

    def access_wave(self, keys) -> WaveAccess:
        uniq = np.unique(np.asarray(keys, dtype=np.int64))
        rows = self._rows
        adm = self.admission
        if adm is not None:
            adm.observe(uniq)                       # sketch sees all traffic
        hits = 0
        for k in uniq.tolist():
            if k in rows:
                rows.move_to_end(k)
                hits += 1
            elif adm is None or len(rows) < self.capacity_rows \
                    or adm.admit(k, next(iter(rows))):
                rows[k] = None
                if len(rows) > self.capacity_rows:
                    rows.popitem(last=False)
                    self.evictions += 1
        misses = int(uniq.size) - hits
        self.total_hits += hits
        self.total_misses += misses
        self.waves += 1
        return WaveAccess(hits=hits, misses=misses)

    def occupy(self, keys) -> int:
        """Insert ``keys`` for capacity pressure without hit/miss
        accounting (landed KV pages, ``pool/kvpool.py``): they compete with
        Engram rows for capacity but are not Engram traffic, so they must
        not move the hit rate. Evictions are counted. Returns the rows
        evicted."""
        uniq = np.unique(np.asarray(keys, dtype=np.int64))
        rows = self._rows
        evicted = 0
        for k in uniq.tolist():
            rows[k] = None
            rows.move_to_end(k)
            if len(rows) > self.capacity_rows:
                rows.popitem(last=False)
                self.evictions += 1
                evicted += 1
        return evicted

    @property
    def hit_rate(self) -> float:
        n = self.total_hits + self.total_misses
        return self.total_hits / n if n else 0.0

    def reset_stats(self) -> None:
        self.total_hits = 0
        self.total_misses = 0
        self.waves = 0
        self.evictions = 0


# ---------------------------------------------------------------------------
# shared cache (one hot-row LRU serving several engine replicas)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SharedCacheStats:
    """Aggregate + per-replica accounting for a ``SharedCache``."""
    capacity_rows: int
    rows: int
    hits: int
    misses: int
    evictions: int
    per_view: dict

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class _SharedCacheView:
    """One replica's handle onto a ``SharedCache``: forwards every wave to
    the shared LRU (so any replica's fetch warms rows for all of them) while
    keeping per-replica hit/miss totals. Duck-types ``LRUHotRowCache`` for
    ``CachedStore`` (``access_wave`` / ``capacity_rows`` / ``hit_rate``)."""

    def __init__(self, shared: "SharedCache", name):
        self.shared = shared
        self.name = name
        self.total_hits = 0
        self.total_misses = 0
        self.waves = 0

    @property
    def capacity_rows(self) -> int:
        return self.shared.cache.capacity_rows

    def __len__(self) -> int:
        return len(self.shared.cache)

    def __contains__(self, key: int) -> bool:
        return key in self.shared.cache

    def access_wave(self, keys) -> WaveAccess:
        wave = self.shared.cache.access_wave(keys)
        self.total_hits += wave.hits
        self.total_misses += wave.misses
        self.waves += 1
        return wave

    def occupy(self, keys) -> int:
        """Capacity-pressure insert (no hit/miss accounting), forwarded to
        the shared LRU: one replica's KV landing evicts fleet-wide."""
        return self.shared.cache.occupy(keys)

    @property
    def hit_rate(self) -> float:
        n = self.total_hits + self.total_misses
        return self.total_hits / n if n else 0.0

    def reset_stats(self) -> None:
        self.total_hits = 0
        self.total_misses = 0
        self.waves = 0


class SharedCache:
    """One hot-row cache shared by N front-ends (the DP case: several
    engine replicas multiplexing one pool).

    Each replica takes a ``view(name)`` and mounts it as the ``cache`` of
    its own ``CachedStore``: rows any replica pulls from the backing tier
    become hits for every other replica, the pooled-tier win a private
    per-replica cache cannot capture. ``stats()`` reports the aggregate
    hit rate plus the per-replica split."""

    def __init__(self, capacity_rows: int, admission=None):
        self.cache = LRUHotRowCache(capacity_rows, admission=admission)
        self.views: dict = {}

    @property
    def capacity_rows(self) -> int:
        return self.cache.capacity_rows

    def view(self, name) -> _SharedCacheView:
        assert name not in self.views, f"duplicate cache view {name!r}"
        v = _SharedCacheView(self, name)
        self.views[name] = v
        return v

    def stats(self) -> SharedCacheStats:
        return SharedCacheStats(
            capacity_rows=self.cache.capacity_rows,
            rows=len(self.cache),
            hits=self.cache.total_hits,
            misses=self.cache.total_misses,
            evictions=self.cache.evictions,
            per_view={n: {"hits": v.total_hits, "misses": v.total_misses,
                          "waves": v.waves, "hit_rate": v.hit_rate}
                      for n, v in self.views.items()})


# ---------------------------------------------------------------------------
# prefix KV cache (chunked prefill's reuse layer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrefixCacheStats:
    """Block-granular accounting for a ``PrefixKVCache``."""
    capacity_bytes: int
    bytes: int
    entries: int
    lookups: int
    hit_blocks: int
    lookup_blocks: int
    inserts: int
    evictions: int
    restored_tokens: int
    per_view: dict = dataclasses.field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        n = self.lookup_blocks
        return self.hit_blocks / n if n else 0.0


class PrefixKVCache:
    """LRU over prefill-state snapshots keyed by chained prefix-block keys.

    An entry is one ``extract_prefix`` snapshot: a whole slot state at a
    chunk boundary, KV sliced to the prefix length. A hit restores
    ``n_blocks * block_tokens`` prompt tokens as one tier fetch instead of
    a prefill pass. ``lookup(chain)`` walks the chain deepest-first and
    returns the deepest snapshot present (a chain key encodes the whole
    prefix, so any present key is a restart point). Inserts evict
    least-recently-used snapshots past ``capacity_bytes``."""

    def __init__(self, capacity_bytes: int, block_tokens: int):
        if capacity_bytes <= 0 or block_tokens <= 0:
            raise ValueError(f"capacity_bytes={capacity_bytes} and "
                             f"block_tokens={block_tokens} must be positive")
        self.capacity_bytes = int(capacity_bytes)
        self.block_tokens = int(block_tokens)
        # key -> (snapshot, n_tokens, nbytes)
        self._entries: OrderedDict[int, tuple] = OrderedDict()
        self.bytes = 0
        self.lookups = 0
        self.hit_blocks = 0
        self.lookup_blocks = 0
        self.inserts = 0
        self.evictions = 0
        self.restored_tokens = 0
        self.views: dict = {}

    def __contains__(self, key: int) -> bool:
        return int(key) in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, chain) -> tuple:
        """Deepest present snapshot for a request's block-chain keys ->
        ``(n_blocks_hit, snapshot, nbytes)`` (``(0, None, 0)`` on a miss)."""
        self.lookups += 1
        self.lookup_blocks += len(chain)
        for i in range(len(chain) - 1, -1, -1):
            ent = self._entries.get(int(chain[i]))
            if ent is not None:
                self._entries.move_to_end(int(chain[i]))
                snap, n_tokens, nbytes = ent
                self.hit_blocks += i + 1
                self.restored_tokens += n_tokens
                return i + 1, snap, nbytes
        return 0, None, 0

    def insert(self, key: int, snapshot, n_tokens: int, nbytes: int) -> bool:
        """Spill one chunk-boundary snapshot, evicting past the byte budget.
        A snapshot larger than the whole budget is rejected rather than
        flushing the cache."""
        key = int(key)
        if key in self._entries or nbytes > self.capacity_bytes:
            return False
        self._entries[key] = (snapshot, int(n_tokens), int(nbytes))
        self.bytes += int(nbytes)
        self.inserts += 1
        while self.bytes > self.capacity_bytes:
            _, (_, _, nb) = self._entries.popitem(last=False)
            self.bytes -= nb
            self.evictions += 1
        return True

    def view(self, name) -> "_PrefixCacheView":
        """A replica's stats window onto this one shared structure (the
        ``SharedCache`` pattern); a private fleet builds one cache per
        replica instead."""
        assert name not in self.views, f"duplicate prefix view {name!r}"
        v = _PrefixCacheView(self, name)
        self.views[name] = v
        return v

    def stats(self) -> PrefixCacheStats:
        return PrefixCacheStats(
            capacity_bytes=self.capacity_bytes, bytes=self.bytes,
            entries=len(self._entries), lookups=self.lookups,
            hit_blocks=self.hit_blocks, lookup_blocks=self.lookup_blocks,
            inserts=self.inserts, evictions=self.evictions,
            restored_tokens=self.restored_tokens,
            per_view={n: {"hit_blocks": v.hit_blocks,
                          "lookup_blocks": v.lookup_blocks,
                          "inserts": v.inserts, "hit_rate": v.hit_rate}
                      for n, v in self.views.items()})


class _PrefixCacheView:
    """One replica's handle onto a shared ``PrefixKVCache``: forwards
    lookups and inserts (any replica's prefill warms prefixes for all of
    them) while keeping per-replica hit accounting. Duck-types the cache
    for the engine (``lookup`` / ``insert`` / ``block_tokens`` /
    ``__contains__``)."""

    def __init__(self, shared: PrefixKVCache, name):
        self.shared = shared
        self.name = name
        self.hit_blocks = 0
        self.lookup_blocks = 0
        self.inserts = 0

    @property
    def block_tokens(self) -> int:
        return self.shared.block_tokens

    def __contains__(self, key: int) -> bool:
        return key in self.shared

    def lookup(self, chain) -> tuple:
        n, snap, nbytes = self.shared.lookup(chain)
        self.lookup_blocks += len(chain)
        self.hit_blocks += n
        return n, snap, nbytes

    def insert(self, key: int, snapshot, n_tokens: int, nbytes: int) -> bool:
        ok = self.shared.insert(key, snapshot, n_tokens, nbytes)
        self.inserts += int(ok)
        return ok

    @property
    def hit_rate(self) -> float:
        n = self.lookup_blocks
        return self.hit_blocks / n if n else 0.0

    def stats(self) -> PrefixCacheStats:
        return self.shared.stats()


def zipf_keys(n: int, vocab: int, *, alpha: float = 1.2,
              seed: int = 0) -> np.ndarray:
    """Zipf-distributed key stream over [0, vocab), the paper's reuse
    assumption, used by tests and benchmarks to drive the cache.

    ``alpha > 1`` draws the rejection-sampled ``rng.zipf`` stream;
    ``alpha <= 1`` (where numpy's sampler is undefined) draws from the
    exact finite Zipf law ``P(rank r) ∝ r^-alpha`` over the vocab."""
    rng = np.random.RandomState(seed)
    if alpha <= 1.0:
        w = np.arange(1, vocab + 1, dtype=np.float64) ** -alpha
        return rng.choice(vocab, size=n, p=w / w.sum()).astype(np.int64)
    ranks = rng.zipf(alpha, size=4 * n)
    ranks = ranks[ranks <= vocab][:n]
    while ranks.size < n:                      # heavy tail can over-reject
        extra = rng.zipf(alpha, size=4 * n)
        ranks = np.concatenate([ranks, extra[extra <= vocab]])[:n]
    return (ranks - 1).astype(np.int64)
