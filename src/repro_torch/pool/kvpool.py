"""Pooled KV page store + KV/Engram link arbiter (preemption's spill tier).

ROADMAP item 1's thesis (ground: Beluga, PAPERS.md): the CXL pool is a
general pooled-memory substrate, not read-only Engram storage — at scale
the big capacity consumer is KV state. This module is the KV side of that
tier:

  * ``KVPagePool`` — a reliable (non-evicting, capacity-refusing) store of
    preempted requests' KV snapshots. An entry is one
    ``serving.slots.extract_prefix`` snapshot of a *running* slot (KV
    sliced to the decoded position), addressed as fixed-size pages:
    ``core.hashing.prefix_chain_keys`` over the request's token stream at
    ``page_tokens`` granularity, plus one crc-chained tail key for the
    partial page (unlike the prefix cache, a preempted request's spill
    must cover every token, not just block boundaries). Page identity is
    what the link arbiter meters and what the hot-row cache sees as
    occupancy pressure. ``spill`` refuses (returns None) when the pool is
    full — a preemption that cannot park its KV does not happen, which is
    the backpressure path.
  * ``PoolArbiter`` — the bandwidth/capacity referee between KV-page and
    Engram-row traffic sharing one pool link + one DRAM front cache.
    Without it, a KV transfer is one monolithic untagged link booking
    (serial FIFO: every Engram wave behind it eats the full horizon) and
    the landed pages occupy the hot-row cache unboundedly, evicting hot
    Engram rows. With it, KV bookings are page-granular under a dedicated
    ``("kv", ...)`` flow owner — the link's processor-sharing wait lets
    Engram waves fair-share past the spill — and KV cache occupancy is
    capped at ``kv_cache_share`` of the cache's capacity. The measurable
    claim (bench_overload scenario C): KV pressure degrades the Engram
    hit rate without the arbiter and the arbiter rescues it.

A copy of ``repro.pool.kvpool`` (host code; the snapshots it parks are the
port's ``extract_prefix`` trees of CPU tensors). The PyTorch port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np

from ..core.hashing import prefix_chain_keys


def kv_page_keys(tokens, page_tokens: int) -> tuple:
    """Page keys for a spilled KV stream: the crc32-chained
    ``prefix_chain_keys`` over whole pages, plus one tail key (same
    chaining discipline, chained through the last full page's digest) when
    the stream ends mid-page — a spill covers every decoded token."""
    keys = list(prefix_chain_keys(tokens, page_tokens))
    toks = [int(t) for t in tokens]
    rem = len(toks) % page_tokens
    if rem or not keys:
        data = np.asarray(toks[len(toks) - rem:], np.int64).tobytes()
        h1 = zlib.crc32(data, (keys[-1] >> 32) & 0xFFFFFFFF if keys else 0)
        h2 = zlib.crc32(data, keys[-1] & 0xFFFFFFFF if keys
                        else 0x9E3779B9)
        keys.append((h1 << 32) | h2)
    return tuple(keys)


@dataclasses.dataclass
class _KVEntry:
    """One preempted request's parked state."""
    rid: int
    snapshot: object                 # extract_prefix host tree
    n_tokens: int                    # KV positions the snapshot carries
    nbytes: int
    pages: tuple                     # kv_page_keys over the token stream


@dataclasses.dataclass
class KVPoolStats:
    capacity_bytes: int = 0
    bytes: int = 0                   # currently parked
    entries: int = 0
    spills: int = 0
    restores: int = 0
    refused: int = 0                 # spill attempts refused for capacity
    spilled_bytes: int = 0           # lifetime spilled
    restored_bytes: int = 0          # lifetime restored
    peak_bytes: int = 0


class KVPagePool:
    """Reliable pooled store of preempted requests' KV snapshots.

    Unlike the LRU caches in this package, parked KV is *owned* state —
    evicting it would kill the request — so the pool refuses new spills at
    capacity instead of evicting, and entries leave only via ``free``
    (restore completed, or the request was cancelled mid-spill)."""

    def __init__(self, capacity_bytes: int, page_tokens: int = 8):
        assert capacity_bytes > 0 and page_tokens > 0, \
            (capacity_bytes, page_tokens)
        self.capacity_bytes = int(capacity_bytes)
        self.page_tokens = int(page_tokens)
        self._entries: dict[int, _KVEntry] = {}
        self._stats = KVPoolStats(capacity_bytes=self.capacity_bytes)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    @property
    def bytes_used(self) -> int:
        return self._stats.bytes

    def has_room(self, nbytes: int) -> bool:
        return self._stats.bytes + int(nbytes) <= self.capacity_bytes

    def spill(self, rid: int, tokens, snapshot, n_tokens: int,
              nbytes: int) -> Optional[tuple]:
        """Park one request's snapshot; returns its page keys, or None
        when the pool is full (the preemption must not happen)."""
        assert rid not in self._entries, rid
        nbytes = int(nbytes)
        if not self.has_room(nbytes):
            self._stats.refused += 1
            return None
        pages = kv_page_keys(tokens, self.page_tokens)
        self._entries[rid] = _KVEntry(rid=rid, snapshot=snapshot,
                                      n_tokens=int(n_tokens),
                                      nbytes=nbytes, pages=pages)
        s = self._stats
        s.bytes += nbytes
        s.entries = len(self._entries)
        s.spills += 1
        s.spilled_bytes += nbytes
        s.peak_bytes = max(s.peak_bytes, s.bytes)
        return pages

    def fetch(self, rid: int) -> _KVEntry:
        """The parked entry (restore reads it; ``free`` releases it)."""
        return self._entries[rid]

    def free(self, rid: int, restored: bool = False) -> bool:
        e = self._entries.pop(rid, None)
        if e is None:
            return False
        s = self._stats
        s.bytes -= e.nbytes
        s.entries = len(self._entries)
        if restored:
            s.restores += 1
            s.restored_bytes += e.nbytes
        return True

    def stats(self) -> KVPoolStats:
        return self._stats


@dataclasses.dataclass
class PoolArbiter:
    """KV-vs-Engram referee on the shared pool link + hot-row cache.

    ``kv_cache_share``: fraction of the hot-row cache's row capacity that
    landed KV pages may occupy (0 = KV bypasses the cache entirely —
    parked pages live in the pool, not the DRAM front). ``paged_link``:
    book KV transfers page-by-page under a ``("kv", rid, page)`` wave tag
    whose flow owner is ``"kv"`` — the link's processor-sharing wait lets
    concurrent Engram waves fair-share past a long spill instead of
    serialising behind one monolithic booking."""
    kv_cache_share: float = 0.0
    paged_link: bool = True

    def cache_occupancy_rows(self, kv_rows: int, capacity_rows: int) -> int:
        """Rows of cache capacity a KV landing of ``kv_rows`` row-
        equivalents may push into the hot-row cache."""
        return min(int(kv_rows),
                   int(capacity_rows * max(0.0, self.kv_cache_share)))
