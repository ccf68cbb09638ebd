"""Three-level tier chain: DRAM front → CXL warm pool → SSD cold tier.

The paper's cost argument (§5) is that Engram's skewed, sparse reuse lets
capacity live in cheaper tiers without hurting TTFT — but a two-level
hierarchy (hot-row cache → one backing tier) caps the modelable table at
DRAM+CXL capacity. ``TierChain`` adds the real third level behind the
same ``EngramStore`` protocol:

  * **DRAM front** — an inclusive, TinyLFU-admission-gated LRU of row
    *copies* (capacity ``StoreConfig.cache_rows``), the chain's hit
    path; its own private DRAM channel, like ``CachedStore``'s cache
    link. Admission rides the same aged sketch as promotion, so a
    one-shot scan can never churn the resident hot set.
  * **CXL warm level** — an exclusive residency partition of capacity
    ``StoreConfig.warm_rows``; fetches ride the fleet-wide tier link, or
    fan out over a ``pool/fabric.PoolFabric`` when one is mounted (the
    chain composes under sharding).
  * **SSD cold level** — everything else. The SSD ``TierSpec`` is
    aggregate-only: a wave's cold misses are charged as ONE scatter-
    gather payload (single device latency + wire), never per-row — the
    TF-Engram batched-read discipline that makes flash viable at all.

Placement between CXL and SSD is driven by the TinyLFU
``FrequencySketch`` with **virtual-clock aging** (``decay_half_life_s``):
counts halve over *clock* time, so a workload shift re-ranks the hot set
(FadeMem-style forgetting applied to row placement). Promotion is STRICT
— a cold row displaces the warm LRU victim only when the sketch ranks it
strictly hotter — so without aging a saturated old hot set freezes the
warm tier forever; with aging it fades and the new hot set wins.

Migrations are **write-behind**: promotion bytes are booked on the warm
medium (the fabric switch when sharded) and demotion write-backs on the
cold link — both under the ``"promote"``/``"demote"`` traffic classes of
the ``StoreStats`` ledgers — but neither extends the demand wave's
latency, mirroring the KV spill write-behind path.

Replay contract: each measured wave records its full route
``(front, warm, cold, promote, demote, warm_split)`` on
``PrefetchHandle.shards``; a ``Segments`` entry carrying that route
re-books every link identically (residency and sketch untouched), so a
chain trace — sharded or not — replays bit-identically (through the
reference's ``simulator.replay_stall_s``, which the port has not yet).

A copy of ``repro.pool.tierchain`` (host code): the PyTorch port imports
nothing of the JAX package.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

from ..configs.base import EngramConfig
from .cache import FrequencySketch
from .store import Segments, _StoreBase, segment_bytes, segment_count
from .tiers import TIERS, chain_levels


class TierChain(_StoreBase):
    """DRAM front → warm pool → cold tier behind ``EngramStore``.

    ``pool_spec``: a ``"CXL+SSD"`` chain string (warm+cold; an optional
    leading level names the front tier, default DRAM). Capacities come
    from ``StoreConfig``: ``cache_rows`` (front), ``warm_rows`` (warm
    partition); ``aging_half_life_s`` > 0 turns on virtual-clock decay
    of the promotion sketch. ``fabric``: mount the warm level on a
    sharded ``PoolFabric`` instead of a single fleet link.
    """

    def __init__(self, ecfg: EngramConfig, pool_spec: str, store_cfg=None,
                 clock=None, fabric=None):
        names = chain_levels(pool_spec)
        if len(names) == 3:
            front_name, warm_name, cold_name = names
        else:
            assert len(names) == 2, \
                f"chain spec needs 2-3 levels, got {pool_spec!r}"
            front_name, (warm_name, cold_name) = "DRAM", names
        super().__init__(ecfg, pool_spec)
        scfg = store_cfg if store_cfg is not None else ecfg.store
        self.front_tier = TIERS[front_name]
        self.warm_tier = fabric.tier if fabric is not None \
            else TIERS[warm_name]
        self.cold_tier = TIERS[cold_name]
        assert self.cold_tier.aggregate, \
            f"cold tier {cold_name} must batch reads (aggregate=True)"
        self.front_rows = int(getattr(scfg, "cache_rows", 0) or 0)
        self.warm_rows = int(getattr(scfg, "warm_rows", 0) or 0)
        assert self.warm_rows > 0, \
            "a tier chain needs StoreConfig.warm_rows > 0"
        half = float(getattr(scfg, "aging_half_life_s", 0.0) or 0.0)
        self.sketch = FrequencySketch(
            decay_half_life_s=half if half > 0.0 else None)
        self.fabric = fabric
        # links: private front channel; warm = fleet tier link (or the
        # fabric's own node/switch links); cold = fleet tier link
        self._front_link = clock.link(f"chainfront:{id(self):x}",
                                      self.front_tier.bandwidth_Bps) \
            if clock is not None and self.front_rows > 0 else None
        self._warm_link = None
        if fabric is None and clock is not None:
            self._warm_link = clock.link(f"tier:{self.warm_tier.name}",
                                         self.warm_tier.bandwidth_Bps)
        self._cold_link = clock.link(f"tier:{self.cold_tier.name}",
                                     self.cold_tier.bandwidth_Bps) \
            if clock is not None else None
        # engine pre-bookings (reserve_prefetch, prefix-KV transfers)
        # ride the warm medium's chokepoint
        self._link = fabric.switch if fabric is not None else self._warm_link
        self._front: OrderedDict[int, None] = OrderedDict()   # inclusive
        self._warm: OrderedDict[int, None] = OrderedDict()    # exclusive
        self._pending_route: Optional[tuple] = None
        self._last_route: Optional[tuple] = None
        self._stats.cache_tier = self.front_tier.name
        self._stats.cache_rows = self.front_rows

    # latency model -----------------------------------------------------
    def latency_for_segments(self, n_segments: int) -> float:
        """Analytic latency with no residency knowledge: the warm path —
        the chain's steady-state expectation once the hot set is placed
        (scalar-mode classification routes the same way). The solver
        (``simulator.chain_read_latency_s``) owns the split-aware model."""
        if n_segments <= 0:
            return 0.0
        if self.fabric is not None:
            lat, _, _ = self.fabric.charge(
                self.fabric.even_split(n_segments), now_s=self._now(),
                clocked=False)
            return lat
        return self.warm_tier.read_latency_s(n_segments,
                                             segment_bytes(self.ecfg))

    def occupancy_s(self, n_segments: int) -> float:
        seg = segment_bytes(self.ecfg)
        if self.fabric is not None:
            return n_segments * seg / self.fabric.switch_Bps
        return self.warm_tier.service_s(n_segments, seg)

    def _now(self) -> float:
        return self.cursor.now_s if self.cursor is not None else 0.0

    # residency ---------------------------------------------------------
    def _route_measured(self, uniq: np.ndarray) -> tuple:
        """Route one measured wave's unique keys through the chain,
        mutating residency + the aged sketch -> the wave's route tuple
        ``(front_n, warm_n, cold_n, promote_n, demote_n, warm_split)``."""
        self.sketch.decay(self._now())
        self.sketch.observe(uniq)
        front, warm = self._front, self._warm
        est = self.sketch.estimate
        front_n = warm_n = cold_n = promote_n = demote_n = 0
        warm_keys: list[int] = []
        for k in uniq.tolist():
            if k in front:
                front.move_to_end(k)
                front_n += 1
                if k in warm:                  # a hit is still row traffic
                    warm.move_to_end(k)
                continue
            if k in warm:
                warm.move_to_end(k)
                warm_n += 1
                warm_keys.append(k)
            else:
                cold_n += 1
                if len(warm) < self.warm_rows:
                    warm[k] = None
                    promote_n += 1
                else:
                    victim = next(iter(warm))
                    c, v = est([k, victim])
                    if c > v:        # STRICT: ties keep the incumbent —
                        # saturated-but-stale sets only lose under aging
                        warm.popitem(last=False)
                        demote_n += 1
                        warm[k] = None
                        promote_n += 1
            if self.front_rows > 0:            # inclusive copy, gated by
                if len(front) < self.front_rows:   # the same aged sketch
                    front[k] = None
                else:
                    fv = next(iter(front))
                    fc, fvv = est([k, fv])
                    if fc > fvv:   # TinyLFU admission: cold keys cannot
                        front.popitem(last=False)  # churn a hot front
                        front[k] = None
        warm_split = None
        if self.fabric is not None and warm_keys:
            warm_split = tuple(
                int(x) for x in self.fabric.split(
                    np.asarray(warm_keys, np.int64)))
        return (front_n, warm_n, cold_n, promote_n, demote_n, warm_split)

    # protocol ----------------------------------------------------------
    def _classify(self, tokens) -> tuple[int, int, int]:
        if isinstance(tokens, Segments):
            if tokens.shards is not None:      # recorded route: replay it
                self._pending_route = tuple(tokens.shards)
            else:                              # analytic split: warm path
                self._pending_route = (tokens.hits, tokens.misses,
                                       0, 0, 0, None)
            return tokens.n, tokens.hits, tokens.misses
        if np.isscalar(tokens) or isinstance(tokens, int):
            n = segment_count(self.ecfg, int(tokens))
            self._pending_route = (0, n, 0, 0, 0, None)
            return n, 0, n
        uniq = np.unique(np.asarray(tokens, dtype=np.int64))
        route = self._route_measured(uniq)
        self._pending_route = route
        front_n = route[0]
        return int(uniq.size), front_n, int(uniq.size) - front_n

    def _charged_latency(self, hits: int, misses: int
                         ) -> tuple[float, float, list]:
        route = self._pending_route
        self._pending_route = None
        if route is None:
            route = (hits, misses, 0, 0, 0, None)
        front_n, warm_n, cold_n, promote_n, demote_n, warm_split = route
        self._last_route = (front_n, warm_n, cold_n, promote_n, demote_n,
                            warm_split)
        seg = segment_bytes(self.ecfg)
        now = self._now()
        clocked = self.cursor is not None
        wave = self.cursor.wave_tag() if clocked else None
        resv: list = []
        # front path (private DRAM channel, CachedStore's hit path)
        t_front = self.front_tier.read_latency_s(front_n, seg) \
            if front_n else 0.0
        w_front = 0.0
        if front_n and clocked and self._front_link is not None:
            w_front, tr = self._front_link.reserve(
                now, self.front_tier.service_s(front_n, seg),
                nbytes=front_n * seg, wave=wave)
            resv.append(tr)
        # warm path (fleet link or multi-node fabric fan-out)
        w_warm = 0.0
        warm_path = 0.0
        if warm_n:
            if self.fabric is not None:
                split = np.asarray(warm_split, np.int64) \
                    if warm_split is not None \
                    else self.fabric.even_split(warm_n)
                warm_path, w_warm, trs = self.fabric.charge(
                    split, now_s=now, wave=wave, clocked=clocked)
                resv.extend(trs)
                self.note_class("engram", warm_n * seg,
                                self.occupancy_s(warm_n))
            else:
                t_warm = self.warm_tier.read_latency_s(warm_n, seg)
                if clocked and self._warm_link is not None:
                    occ = self.warm_tier.service_s(warm_n, seg)
                    w_warm, tr = self._warm_link.reserve(
                        now, occ, nbytes=warm_n * seg, wave=wave,
                        klass="engram")
                    resv.append(tr)
                self.note_class("engram", warm_n * seg,
                                self.warm_tier.service_s(warm_n, seg))
                warm_path = t_warm + w_warm
        # cold path: ONE scatter-gather payload (aggregate TierSpec)
        w_cold = 0.0
        cold_path = 0.0
        if cold_n:
            t_cold = self.cold_tier.read_latency_s(cold_n, seg)
            occ = self.cold_tier.service_s(cold_n, seg)
            if clocked and self._cold_link is not None:
                w_cold, tr = self._cold_link.reserve(
                    now, occ, nbytes=cold_n * seg, wave=wave,
                    klass="engram")
                resv.append(tr)
            self.note_class("engram", cold_n * seg, occ)
            cold_path = t_cold + w_cold
        # all three proceed in parallel (independent hardware)
        lat = max(t_front + w_front, warm_path, cold_path)
        wait = max(w_front, w_warm, w_cold)
        # write-behind migrations: booked on the clock (they contend with
        # later waves) but never extend THIS wave — the demand rows are
        # already in hand when placement moves them
        if promote_n:
            occ = self.occupancy_s(promote_n)
            if clocked and self._link is not None:
                _, tr = self._link.reserve(now, occ,
                                           nbytes=promote_n * seg,
                                           wave=wave, klass="promote")
                resv.append(tr)
            self.note_class("promote", promote_n * seg, occ)
        if demote_n:
            occ = self.cold_tier.service_s(demote_n, seg)
            if clocked and self._cold_link is not None:
                _, tr = self._cold_link.reserve(now, occ,
                                                nbytes=demote_n * seg,
                                                wave=wave, klass="demote")
                resv.append(tr)
            self.note_class("demote", demote_n * seg, occ)
        s = self._stats
        s.warm_hits += warm_n
        s.cold_misses += cold_n
        s.promotions += promote_n
        s.demotions += demote_n
        return lat, wait, resv

    def prefetch(self, tokens, fetch=None):
        h = super().prefetch(tokens, fetch=fetch)
        h.shards = self._last_route        # recorded for trace replay
        return h
