"""Sharded pool fabric: Engram tables spread over M pool nodes behind one
CXL switch, with failure injection and live shard rescue.

The paper's fleet (§2.2, Table 3) is not "a pool": it is pool *nodes* —
each a controller + DRAM behind its own adapter — aggregated by an XConn-
class switch whose port budget (``pool/cost.py CXL_SWITCH_BW_Bps``) every
reader shares. Until this module the reproduction collapsed that fabric
to a single tier link; here it becomes explicit:

  * ``PoolFabric``  — the topology. Tables are hash-sharded by stable
    crc32 over the packed segment keys (``core/hashing`` produces them;
    ``shard_of`` routes them — never Python ``hash()``, which is salted
    per process). Each node owns a ``VirtualClock`` ``Link`` at the tier's
    adapter bandwidth; one extra ``Link`` models the shared switch port.
    A wave's fan-out is charged as software setup + max over the nodes it
    touches (each node serves its own sub-batch concurrently) with switch
    occupancy composed on top — the max-of-shards-plus-switch model.
  * ``FabricStore`` — the ``EngramStore`` backend mounting a fabric
    (``make_store(..., fabric=...)``). Measured mode routes the wave's
    real unique keys; analytic/trace mode uses the recorded per-shard
    split (``Segments.shards``) or a deterministic even split.

Failure injection (the §6 RDMA-rescue test generalized to a fleet drill):

  * ``degrade(node, factor)`` — the node's service time scales by
    ``factor`` (a flaky adapter / thermal throttle).
  * ``kill(node)``            — the node's shards are re-placed round-
    robin onto survivors. Each re-placed shard's copy (backing tier ->
    switch -> destination adapter) is booked on the live links, so the
    rescue contends with serving traffic honestly; until a shard's copy
    lands (``done_s``), reads to it fall back to the backing tier
    (``fallback``, default RDMA) — degraded, not unavailable.

Replay contract: a no-failure trace recorded through a fabric-backed
store replays bit-identically — the recorded ``Segments.shards`` splits
drive the same charge code on a fresh fabric with the same static
placement (the reference's ``simulator.replay_stall_s`` is not ported
yet; the splits are recorded all the same).

A copy of ``repro.pool.fabric`` (host code): the PyTorch port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..configs.base import EngramConfig
from .cost import CXL_SWITCH_BW_Bps
from .store import _StoreBase, segment_bytes, segment_count
from .tiers import TIERS, TierSpec


# ---------------------------------------------------------------------------
# shard routing: vectorized crc32 over packed segment keys
# ---------------------------------------------------------------------------

def _crc32_table() -> np.ndarray:
    poly = np.uint32(0xEDB88320)
    tab = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        tab = np.where(tab & 1, (tab >> 1) ^ poly, tab >> 1)
    return tab


_CRC_TABLE = _crc32_table()


def crc32_keys(keys) -> np.ndarray:
    """crc32 of each int64 key's 8 little-endian bytes, vectorized —
    bit-identical to ``zlib.crc32(key.astype('<i8').tobytes())`` per
    element, and (unlike Python ``hash()``) stable across processes."""
    k = np.ascontiguousarray(np.asarray(keys, np.int64).reshape(-1)) \
        .view(np.uint64)
    crc = np.full(k.shape, 0xFFFFFFFF, np.uint32)
    for b in range(8):
        byte = ((k >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint32)
        crc = (crc >> np.uint32(8)) ^ _CRC_TABLE[(crc ^ byte)
                                                 & np.uint32(0xFF)]
    return crc ^ np.uint32(0xFFFFFFFF)


def shard_of(keys, n_shards: int) -> np.ndarray:
    """Shard id in ``[0, n_shards)`` for each packed segment key."""
    return (crc32_keys(keys) % np.uint32(max(1, int(n_shards)))) \
        .astype(np.int64)


# ---------------------------------------------------------------------------
# the fabric
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FabricNode:
    """One pool node: controller + DRAM behind its own adapter link."""
    name: str
    link: object = None                # clock Link (None when unclocked)
    degrade_factor: float = 1.0        # service-time multiplier (>= 1)
    alive: bool = True


class PoolFabric:
    """M pool nodes behind one switch port; shards routed by crc32.

    ``n_shards`` defaults to one shard per node; more shards than nodes
    gives the re-placement after ``kill()`` finer granularity. ``clock``
    binds the per-node / switch / fallback links onto a fleet
    ``VirtualClock`` — unclocked fabrics charge the pure analytic model
    (zero waits), which is what trace replay and the latency tables use.
    """

    def __init__(self, ecfg: EngramConfig, n_nodes: int, *,
                 tier: TierSpec | str = "CXL", clock=None,
                 switch_Bps: float = CXL_SWITCH_BW_Bps,
                 fallback: TierSpec | str = "RDMA",
                 n_shards: Optional[int] = None, name: str = "fabric"):
        assert int(n_nodes) >= 1, n_nodes
        self.ecfg = ecfg
        self.tier = TIERS[tier] if isinstance(tier, str) else tier
        self.fallback = TIERS[fallback] if isinstance(fallback, str) \
            else fallback
        self.n_nodes = int(n_nodes)
        self.n_shards = self.n_nodes if n_shards is None else int(n_shards)
        assert self.n_shards >= self.n_nodes, (self.n_shards, self.n_nodes)
        self.switch_Bps = float(switch_Bps)
        self.clock = clock
        self.name = name
        self.nodes = [
            FabricNode(f"{name}:node{i}",
                       link=clock.link(f"{name}:node{i}",
                                       self.tier.bandwidth_Bps)
                       if clock is not None else None)
            for i in range(self.n_nodes)]
        self.switch = clock.link(f"{name}:switch", self.switch_Bps) \
            if clock is not None else None
        self.fallback_link = clock.link(f"{name}:fallback",
                                        self.fallback.bandwidth_Bps) \
            if clock is not None else None
        # shard -> node; round-robin start, re-placed on kill()
        self.placement = (np.arange(self.n_shards, dtype=np.int64)
                          % self.n_nodes)
        self._rescuing: dict[int, float] = {}   # shard -> copy done_s
        self.rescues: list[dict] = []
        self.events: list[dict] = []

    # --------------------------------------------------------- geometry

    @property
    def table_bytes(self) -> int:
        """Full Engram table footprint across every Engram layer."""
        e = self.ecfg
        return (len(e.layers) * e.n_tables * e.table_vocab
                * segment_bytes(e))

    @property
    def shard_bytes(self) -> int:
        return -(-self.table_bytes // self.n_shards)

    @property
    def rescue_copy_s(self) -> float:
        """Uncontended single-shard rescue copy time: the shard streams
        backing tier -> switch -> destination adapter; the slowest leg
        sets the pace (the bench's recovery budget is built on this)."""
        bw = min(self.fallback.bandwidth_Bps, self.switch_Bps,
                 self.tier.bandwidth_Bps)
        return self.shard_bytes / bw

    # ---------------------------------------------------------- routing

    def shard_ids(self, keys) -> np.ndarray:
        return shard_of(keys, self.n_shards)

    def split(self, keys) -> np.ndarray:
        """Per-shard counts (length ``n_shards``) of the given keys —
        callers pass the wave's *unique* key stream."""
        return np.bincount(self.shard_ids(keys), minlength=self.n_shards) \
            .astype(np.int64)

    def even_split(self, n: int) -> np.ndarray:
        """Deterministic even split of ``n`` segments over shards — the
        analytic stand-in when no key stream exists (token counts, cache
        miss counts, scalar trace entries). crc32 spreads real keys near-
        uniformly, so even is the honest expectation, and determinism is
        what the replay contract needs."""
        n = max(0, int(n))
        base, rem = divmod(n, self.n_shards)
        out = np.full(self.n_shards, base, np.int64)
        out[:rem] += 1
        return out

    # --------------------------------------------------------- charging

    def _node_groups(self, split: np.ndarray, now_s: float) -> list:
        """Aggregate a per-shard split into per-node sub-batches ->
        ``[(node_id, count), ...]`` plus the fallback count (shards whose
        rescue copy hasn't landed read the backing tier instead)."""
        for s in [s for s, d in self._rescuing.items() if d <= now_s]:
            del self._rescuing[s]                # copy landed
        counts: dict[int, int] = {}
        fb = 0
        for s in np.flatnonzero(split):
            c = int(split[s])
            if s in self._rescuing:
                fb += c
            else:
                nd = int(self.placement[s])
                counts[nd] = counts.get(nd, 0) + c
        return sorted(counts.items()), fb

    def charge(self, split, now_s: float = 0.0, wave=None,
               clocked: bool = True) -> tuple[float, float, list]:
        """Charge one wave's multi-node fan-out.

        ``split``: per-shard unique segment counts. Latency = requester-
        side software on the total + max over (per-node service + queue
        wait, fallback path, switch occupancy + wait): each node serves
        its sub-batch concurrently, the switch port carries every byte.
        -> (latency incl. waits, wait alone, link reservations)."""
        split = np.asarray(split, np.int64)
        assert split.size == self.n_shards, (split.size, self.n_shards)
        n_total = int(split.sum())
        if n_total <= 0:
            return 0.0, 0.0, []
        seg = segment_bytes(self.ecfg)
        groups, fb = self._node_groups(split, now_s)
        resv = []
        path = path_base = 0.0
        for nd, count in groups:
            node = self.nodes[nd]
            svc = self.tier.service_s(count, seg) * node.degrade_factor
            wait = 0.0
            if clocked and node.link is not None:
                wait, tr = node.link.reserve(now_s, svc,
                                             nbytes=count * seg, wave=wave)
                resv.append(tr)
            path_base = max(path_base, svc)
            path = max(path, svc + wait)
        if fb:
            # rescue window: the shard's rows come from the backing tier,
            # software and all (an RDMA get is priced like one)
            svc = self.fallback.service_s(fb, seg)
            soft = self.fallback.software_s(fb)
            wait = 0.0
            if clocked and self.fallback_link is not None:
                wait, tr = self.fallback_link.reserve(
                    now_s, svc, nbytes=fb * seg, wave=wave)
                resv.append(tr)
            path_base = max(path_base, soft + svc)
            path = max(path, soft + svc + wait)
        sw_svc = n_total * seg / self.switch_Bps
        sw_wait = 0.0
        if clocked and self.switch is not None:
            sw_wait, tr = self.switch.reserve(now_s, sw_svc,
                                              nbytes=n_total * seg,
                                              wave=wave)
            resv.append(tr)
        soft = self.tier.software_s(n_total)
        lat = soft + max(path, sw_svc + sw_wait)
        base = soft + max(path_base, sw_svc)
        return lat, max(0.0, lat - base), resv

    # ------------------------------------------------- failure injection

    def degrade(self, node: int, factor: float) -> None:
        """Scale ``node``'s service time by ``factor`` (>= 1; 1 heals)."""
        assert factor >= 1.0, factor
        nd = self.nodes[int(node)]
        assert nd.alive, f"node {node} is dead"
        nd.degrade_factor = float(factor)
        self.events.append({"t": self._now(), "kind": "degrade",
                            "node": int(node), "factor": float(factor)})

    def kill(self, node: int, now_s: Optional[float] = None) -> float:
        """Kill ``node`` mid-serving: its shards re-place round-robin
        onto survivors, and each shard's rescue copy (backing tier ->
        switch -> destination adapter) is booked on the live links so the
        rescue contends with serving traffic. Until a shard's copy lands
        reads to it pay the fallback tier. Returns the rescue horizon
        (virtual time every moved shard is resident again)."""
        node = int(node)
        nd = self.nodes[node]
        assert nd.alive, f"node {node} already dead"
        now = float(now_s) if now_s is not None else self._now()
        nd.alive = False
        survivors = [i for i, n in enumerate(self.nodes) if n.alive]
        assert survivors, "cannot kill the last pool node"
        moved = [int(s) for s in np.flatnonzero(self.placement == node)]
        nbytes = self.shard_bytes
        done = now
        for j, s in enumerate(moved):
            dst = survivors[j % len(survivors)]
            self.placement[s] = dst
            tag = ("rescue", node, s)
            legs = [(self.fallback_link,
                     nbytes / self.fallback.bandwidth_Bps),
                    (self.switch, nbytes / self.switch_Bps),
                    (self.nodes[dst].link,
                     nbytes / self.tier.bandwidth_Bps
                     * self.nodes[dst].degrade_factor)]
            shard_done = now
            for link, svc in legs:
                if link is not None:
                    _, tr = link.reserve(now, svc, nbytes=nbytes, wave=tag)
                    shard_done = max(shard_done, tr.end_s)
                else:
                    shard_done = max(shard_done, now + svc)
            self._rescuing[s] = shard_done
            self.rescues.append({"shard": s, "src": node, "dst": int(dst),
                                 "t_kill": now, "done_s": shard_done})
            done = max(done, shard_done)
        self.events.append({"t": now, "kind": "kill", "node": node,
                            "moved": moved, "done_s": done})
        return done

    def rescue_done_s(self) -> float:
        """Horizon of the latest booked rescue copy (0 when none)."""
        return max((r["done_s"] for r in self.rescues), default=0.0)

    # -------------------------------------------------------------- misc

    def _now(self) -> float:
        return self.clock.now_s if self.clock is not None else 0.0

    def stats(self) -> dict:
        return {
            "tier": self.tier.name,
            "n_nodes": self.n_nodes,
            "n_shards": self.n_shards,
            "switch_Bps": self.switch_Bps,
            "placement": [int(p) for p in self.placement],
            "alive": [n.alive for n in self.nodes],
            "degrade": [n.degrade_factor for n in self.nodes],
            "rescues": list(self.rescues),
            "events": list(self.events),
            "links": {ln.name: ln.stats() for ln in
                      ([n.link for n in self.nodes]
                       + [self.switch, self.fallback_link]) if ln},
        }


# ---------------------------------------------------------------------------
# the store backend
# ---------------------------------------------------------------------------

class FabricStore(_StoreBase):
    """``EngramStore`` backend over a ``PoolFabric``.

    Measured mode (key arrays) routes each wave's unique keys to their
    shards; ``Segments`` entries carrying a recorded ``shards`` split
    replay it verbatim; scalar/analytic waves use the deterministic even
    split. ``_link`` is the switch port — the engine's pre-bookings
    (pipelined speculative prefetch, prefix-KV byte transfers) ride the
    one resource every fabric byte crosses."""

    def __init__(self, ecfg: EngramConfig, fabric: PoolFabric):
        super().__init__(ecfg, fabric.tier.name)
        self.fabric = fabric
        self.tier = fabric.tier            # CachedStore fronting contract
        self._link = fabric.switch
        self._pending_split: Optional[np.ndarray] = None
        self._last_split: Optional[tuple] = None

    # latency model -----------------------------------------------------
    def latency_for_segments(self, n_segments: int) -> float:
        if n_segments <= 0:
            return 0.0
        lat, _, _ = self.fabric.charge(self.fabric.even_split(n_segments),
                                       now_s=self._now(), clocked=False)
        return lat

    def occupancy_s(self, n_segments: int) -> float:
        # pre-bookings occupy the switch port (the shared chokepoint);
        # per-node occupancy is priced when the real keys arrive
        return n_segments * segment_bytes(self.ecfg) / self.fabric.switch_Bps

    # routing + charging ------------------------------------------------
    def _now(self) -> float:
        return self.cursor.now_s if self.cursor is not None else 0.0

    def _classify(self, tokens):
        from .store import Segments
        if isinstance(tokens, Segments):
            self._pending_split = (
                np.asarray(tokens.shards, np.int64)
                if tokens.shards is not None
                else self.fabric.even_split(tokens.n))
            return tokens.n, tokens.hits, tokens.misses
        if np.isscalar(tokens) or isinstance(tokens, int):
            n = segment_count(self.ecfg, int(tokens))
            self._pending_split = self.fabric.even_split(n)
            return n, 0, n
        uniq = np.unique(np.asarray(tokens, dtype=np.int64))
        self._pending_split = self.fabric.split(uniq)
        return int(uniq.size), 0, int(uniq.size)

    def _charged_latency(self, hits: int, misses: int
                         ) -> tuple[float, float, list]:
        split = self._pending_split
        self._pending_split = None
        if split is None:
            split = self.fabric.even_split(hits + misses)
        self._last_split = tuple(int(x) for x in split)
        wave = self.cursor.wave_tag() if self.cursor is not None else None
        return self.fabric.charge(split, now_s=self._now(), wave=wave,
                                  clocked=self.cursor is not None)

    def charge_misses(self, misses: int) -> tuple[float, float, list]:
        """Charge a cache-miss wave's fan-out for a fronting
        ``CachedStore`` (even split: the hot-row cache counts misses but
        does not retain which keys they were)."""
        if misses <= 0:
            return 0.0, 0.0, []
        wave = self.cursor.wave_tag() if self.cursor is not None else None
        return self.fabric.charge(self.fabric.even_split(misses),
                                  now_s=self._now(), wave=wave,
                                  clocked=self.cursor is not None)

    def prefetch(self, tokens, fetch=None):
        h = super().prefetch(tokens, fetch=fetch)
        h.shards = self._last_split        # recorded for trace replay
        return h
