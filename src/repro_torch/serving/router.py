"""Multi-replica router: N engine replicas multiplexing one Engram pool.

The paper's Table 3 serves a CXL pool from several SGLang replicas (DP):
the pool — and with it the §6 hot-row cache — is *shared* infrastructure.
A private per-replica cache re-fetches every hot row once per replica;
one shared cache lets replica B hit rows replica A already pulled from
the backing tier. The router builds exactly that:

  * N `Engine` replicas (shared params, private decode state/slots), each
    wrapped in its `EngramRuntime`;
  * one `SharedCache` (pool/cache.py) mounted as every replica's
    `CachedStore` front-end (pool/store.py `make_store(cache=...)`), with
    per-replica and aggregate `stats()`;
  * pluggable dispatch: `round_robin`, `least_loaded` (fewest queued +
    live requests), `cache_affinity` (segment-key hash of the prompt, so
    repeat prompts land on the replica whose proposer/KV state is warm —
    the shared cache makes *row* locality replica-agnostic either way).

`submit()` routes one request; `step()` advances every busy replica one
serving wave; `drain()` runs the fleet to idle and returns the aggregate
`EngineStats` (counters summed, wall clock = slowest replica — replicas
model parallel hardware, not a serial loop).

PyTorch port of ``repro.serving.router``. The replicas share one parameter
tree on one device, with ONE f32 head (``models.layers.with_f32_head`` is
applied once, before the replicas are built). On one card ``step()`` runs
the replicas' waves one after another, so the merged ``wall_s`` is the
parallel-hardware model's, not the card's: time a fleet drive on the host
clock to see what the card did. Dispatch and re-dispatch read host state
only (queue and slot lists, the numpy affinity hash), so the fleet adds no
device read to the replicas' one per wave.
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Optional

import numpy as np

from ..core.hashing import host_engram_indices
from ..device import resolve_device
from ..models.layers import with_f32_head
from ..models.params import init_params, table_memory_for
from ..pool.cache import (PrefixCacheStats, PrefixKVCache, SharedCache,
                          SharedCacheStats, TinyLFUAdmission)
from ..pool.kvpool import KVPagePool, KVPoolStats, PoolArbiter
from ..pool.store import make_store, segment_keys
from ..pool.tiers import TIERS, is_chain, pool_tier
from .clock import VirtualClock
from .engine import Engine, EngineStats, Request
from .runtime import EngramRuntime, RequestHandle, TokenEvent
from .slo import OverloadPolicy

POLICIES = ("round_robin", "least_loaded", "cache_affinity")


@dataclasses.dataclass
class RouterStats:
    """Fleet view: aggregate + per-replica engine stats, shared-cache
    accounting (None when the fleet runs private/no caches)."""
    aggregate: EngineStats
    per_replica: dict
    cache: Optional[SharedCacheStats] = None
    migrations: int = 0                 # mid-flight re-dispatches
    clock: Optional[dict] = None        # VirtualClock.stats() snapshot
    prefix_cache: Optional[PrefixCacheStats] = None   # fleet prefix KV
    fabric: Optional[dict] = None       # PoolFabric.stats() snapshot
    # --- overload policy (serving/slo.py) --------------------------------
    shed: int = 0                       # requests refused at admission
    deferred: int = 0                   # requests back-pressured (backlog)
    shed_by_class: dict = dataclasses.field(default_factory=dict)
    kv_pool: Optional[KVPoolStats] = None   # shared KV spill pool snapshot

    @property
    def cache_hit_rate(self) -> float:
        return self.cache.hit_rate if self.cache is not None else 0.0

    @property
    def preemptions(self) -> int:
        """Fleet preemptions (merged across replicas by the aggregate)."""
        return self.aggregate.preemptions

    @property
    def resumes(self) -> int:
        """Fleet restore-and-resumes (merged across replicas)."""
        return self.aggregate.resumes

    @property
    def acceptance_rate(self) -> float:
        """Fleet speculation acceptance: per-replica ``proposed_tokens`` /
        ``accepted_tokens`` are merged into the aggregate, so this is the
        traffic-weighted fleet rate (not a mean of per-replica rates)."""
        return self.aggregate.acceptance_rate

    @property
    def speculation(self) -> dict:
        """Fleet + per-replica speculation metrics in one dict — the
        router-level counterpart of ``EngineStats``' spec counters.
        ``by_class`` splits proposer quality by workload traffic class
        (zipf vs uniform prompts — the n-gram proposer's acceptance is a
        property of the traffic's reuse, so the split is the metric that
        says *which* traffic speculation is paying for)."""
        by_class = {
            klass: {"proposed_tokens": d.get("proposed", 0),
                    "accepted_tokens": d.get("accepted", 0),
                    "acceptance_rate": (d.get("accepted", 0)
                                        / d["proposed"]
                                        if d.get("proposed") else 0.0)}
            for klass, d in self.aggregate.spec_by_class.items()}
        return {
            "proposed_tokens": self.aggregate.proposed_tokens,
            "accepted_tokens": self.aggregate.accepted_tokens,
            "acceptance_rate": self.aggregate.acceptance_rate,
            "pipeline_hit_rate": self.aggregate.pipeline_hit_rate,
            "by_class": by_class,
            "per_replica": {
                name: {"proposed_tokens": s.proposed_tokens,
                       "accepted_tokens": s.accepted_tokens,
                       "acceptance_rate": s.acceptance_rate}
                for name, s in self.per_replica.items()},
        }


class _AdmissionHandle:
    """Handle for a request the admission controller held at the router:
    ``deferred`` (parked in the class backlog; once its class queue drains
    below cap the router dispatches it and this handle proxies the real
    ``RequestHandle``) or ``shed`` (dropped outright — a terminal state,
    no tokens ever arrive). Mirrors the ``RequestHandle`` surface readers
    consume (``request`` / ``rid`` / ``status`` / ``finished`` /
    ``tokens`` / ``cancel``), so `serve()`'s handle list stays uniform
    across admission outcomes. The placeholder ``Request`` carries a
    NEGATIVE rid — it never collides with the replicas' rid ranges."""

    def __init__(self, router: "Router", request: Request):
        self.router = router
        self.request = request
        self.inner: Optional[RequestHandle] = None

    def _bind(self, inner: RequestHandle) -> None:
        """The backlog dispatched the request: adopt the real engine-side
        Request (tokens, stamps, status all flow from it)."""
        self.inner = inner
        self.request = inner.request

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def status(self) -> str:
        return self.request.status

    @property
    def finished(self) -> bool:
        return self.inner is not None and self.inner.finished

    @property
    def cancelled(self) -> bool:
        return self.request.status == "cancelled"

    @property
    def tokens(self) -> list:
        return list(self.request.out)

    def cancel(self) -> bool:
        if self.inner is not None:
            return self.inner.cancel()
        dq = self.router._backlog.get(self.request.slo)
        if dq is not None:
            for item in dq:
                if item[0] is self:
                    dq.remove(item)
                    self.request.status = "cancelled"
                    return True
        return False


class Router:
    def __init__(self, cfg, *, replicas: int = 2, pool: Optional[str] = None,
                 policy: str = "round_robin", shared_cache: bool = True,
                 params=None, seed: int = 0,
                 redispatch: Optional[bool] = None,
                 redispatch_skew: int = 2,
                 prefix_cache_bytes: int = 0,
                 shared_prefix_cache: bool = True,
                 fabric_nodes: Optional[int] = None,
                 slo_policy: Optional[OverloadPolicy] = None,
                 arbiter: Optional[PoolArbiter] = None, **engine_kwargs):
        """``shared_cache``: mount one `SharedCache` across all replicas
        (needs ``pool`` and ``cfg.engram.store.cache_rows > 0``); False
        keeps the per-replica private caches `make_store` would build —
        the baseline the shared cache is measured against.

        ``prefix_cache_bytes``: byte budget for a prefix KV cache
        (pool/cache.PrefixKVCache) over chunk-boundary prefill snapshots;
        needs ``prefill_chunk`` in the engine kwargs. With
        ``shared_prefix_cache`` (default) the fleet mounts ONE cache —
        replica B restores the prefix replica A prefilled, so shared
        Zipf prefixes are prefilled once fleet-wide — while False gives
        each replica a private cache of the same budget (the baseline
        the ≥2x prefill-FLOPs claim is measured against).

        ``redispatch``: continuous re-dispatch — every `step()` the router
        re-examines fleet load on the shared clock and migrates *queued*
        (not yet admitted) requests off a replica whose backlog exceeds
        the least-loaded replica's by ``redispatch_skew``. Defaults to on
        for `least_loaded` (dispatch-time balance decays as completion
        times diverge mid-flight) and off for `cache_affinity` (migration
        would defeat proposer/KV warmth) and `round_robin`.

        ``fabric_nodes``: shard the Engram pool over that many nodes
        behind one switch (pool/fabric.PoolFabric). The fleet shares ONE
        fabric — every replica's waves contend on the same per-node and
        switch-port links, and a mid-serving ``router.fabric.kill(n)``
        degrades every replica at once (the failure drill). A named
        router parameter, not an engine kwarg: forwarding it would build
        M nodes *per replica*.

        ``slo_policy``: an ``OverloadPolicy`` (serving/slo.py). The router
        runs its ADMISSION side — bounded per-class queues with shed /
        back-pressure (``submit`` may return an ``_AdmissionHandle``) and
        a backlog drained as class queues empty — and threads the policy
        into every replica for priority dispatch + preemption, with ONE
        fleet-shared ``KVPagePool`` (preempted KV parks in the pooled
        tier, which is shared infrastructure, not per-replica DRAM).
        ``arbiter``: the KV-vs-Engram ``PoolArbiter``, also fleet-wide.

        ``params``: one parameter tree on the engines' device (default:
        ``init_params`` with ``table_memory_for(cfg, flags)``), shared by
        every replica; ``device`` and the other engine kwargs reach every
        ``Engine``."""
        assert replicas >= 1, replicas
        assert policy in POLICIES, (policy, POLICIES)
        self.cfg = cfg
        self.policy = policy
        self.slo_policy = slo_policy
        self.arbiter = arbiter
        self.kv_pool: Optional[KVPagePool] = None
        if slo_policy is not None and slo_policy.preempt:
            self.kv_pool = KVPagePool(slo_policy.spill_pool_bytes,
                                      slo_policy.spill_page_tokens)
        # per-class deferred backlog: (handle, prompt, max_new, arrival_s,
        # klass) tuples, drained FIFO by step() as class queues empty
        self._backlog: dict[str, deque] = {}
        self.shed = 0
        self.deferred = 0
        self.shed_by_class: dict[str, int] = {}
        self._held_rid = 0              # negative rids for held requests
        self.redispatch = (policy == "least_loaded") if redispatch is None \
            else bool(redispatch)
        self.redispatch_skew = max(1, int(redispatch_skew))
        self.migrations = 0
        # ONE timeline for the fleet: every replica's waves and store
        # transfers interleave on it (serving/clock.py)
        self.clock = VirtualClock()
        self.shared_cache: Optional[SharedCache] = None
        cache_link = None
        # contention links only exist at the emulated operating point
        # (see Engine.__init__: real-mode cursors mirror wall time, so
        # cross-replica queueing would double-count host serialization)
        link_clock = self.clock \
            if engine_kwargs.get("emulate_step_s") is not None else None
        self.fabric = None
        if (fabric_nodes and pool is not None and cfg.engram is not None
                and cfg.engram.enabled):
            from ..pool.fabric import PoolFabric
            # chain specs ("CXL+SSD") shard their WARM level over the
            # fabric; the chain store owns the cold tier's own link
            self.fabric = PoolFabric(cfg.engram, int(fabric_nodes),
                                     tier=pool_tier(pool), clock=link_clock)
        scfg = cfg.engram.store if cfg.engram is not None else None
        if (shared_cache and pool is not None and not is_chain(pool)
                and scfg is not None
                and cfg.engram.enabled and scfg.cache_rows > 0):
            adm = TinyLFUAdmission() if scfg.admission == "tinylfu" else None
            self.shared_cache = SharedCache(scfg.cache_rows, admission=adm)
            # one DRAM channel behind the one shared cache: N replicas
            # hitting it split its bandwidth (the Table 3 switch model),
            # unlike private caches which each own a private link
            if link_clock is not None:
                cache_link = link_clock.link(
                    "cache:shared", TIERS[scfg.cache_tier].bandwidth_Bps)
        self.prefix_cache: Optional[PrefixKVCache] = None
        if prefix_cache_bytes > 0:
            chunk = engine_kwargs.get("prefill_chunk")
            assert chunk, "prefix_cache_bytes needs prefill_chunk"
            if shared_prefix_cache:
                self.prefix_cache = PrefixKVCache(prefix_cache_bytes, chunk)
        if params is None:
            params = init_params(
                cfg, seed, resolve_device(engine_kwargs.get("device")),
                table_memory=table_memory_for(cfg, engine_kwargs.get("flags")))
        # one f32 head for the fleet: each Engine keeps a w32 it is given
        params = with_f32_head(params)
        self.replicas: list[EngramRuntime] = []
        for r in range(replicas):
            name = f"replica{r}"
            store = None
            if self.shared_cache is not None:
                store = make_store(cfg.engram, pool,
                                   cache=self.shared_cache.view(name),
                                   clock=link_clock, cache_link=cache_link,
                                   fabric=self.fabric)
            pfx = None
            if self.prefix_cache is not None:
                pfx = self.prefix_cache.view(name)
            elif prefix_cache_bytes > 0:
                # private baseline: same budget, no cross-replica reuse
                pfx = PrefixKVCache(prefix_cache_bytes,
                                    engine_kwargs["prefill_chunk"])
            # disjoint rid ranges: fleet-wide request ids stay unique, so
            # merged TokenEvent streams and handle lookups never collide
            eng = Engine(cfg, params=params, pool=pool, seed=seed,
                         store=store, name=name, rid_start=r * 1_000_000,
                         clock=self.clock, prefix_cache=pfx,
                         fabric=self.fabric, slo_policy=slo_policy,
                         kv_pool=self.kv_pool, arbiter=arbiter,
                         **engine_kwargs)
            self.replicas.append(eng.runtime())
        self._rr = 0

    # ------------------------------------------------------------- dispatch

    def _load(self, rt: EngramRuntime) -> int:
        eng = rt.engine
        # spilled requests count: a preempted/restoring request still owns
        # pooled capacity and will reclaim a slot on this replica
        return (len(eng.queue) + len(eng._spilled)
                + sum(s is not None for s in eng.slots))

    def _queued_class(self, slo: str) -> int:
        """Fleet-wide queued-but-unadmitted depth of one SLO class (the
        admission cap's observable; the backlog is NOT counted — it is
        the overflow the cap protects the queues from)."""
        return sum(1 for rt in self.replicas
                   for r in rt.engine.queue if r.slo == slo)

    def _affinity_hash(self, prompt) -> int:
        """Stable segment-key hash of the prompt: identical (and
        prefix-shared) prompts map to the same replica. Host numpy only
        (``host_engram_indices``, bit-equal to the device hash), so a
        submit never reads the device."""
        e = self.cfg.engram
        if e is not None and e.enabled:
            idx = host_engram_indices(e, np.asarray([list(prompt)],
                                                    np.int32))
            keys = segment_keys(e, idx).astype(np.uint64)
            mixed = keys * np.uint64(0x9E3779B97F4A7C15)
            return int(np.bitwise_xor.reduce(mixed) & np.uint64(0x7FFFFFFF))
        # crc32, not hash(): PYTHONHASHSEED salts tuple hashes per process,
        # which would scatter identical prompts across replicas between
        # runs — affinity must be fleet- and process-deterministic
        data = np.asarray([int(t) for t in prompt], np.int64).tobytes()
        return zlib.crc32(data) & 0x7FFFFFFF

    def select_replica(self, prompt) -> int:
        if len(self.replicas) == 1:
            return 0
        if self.policy == "round_robin":
            idx = self._rr % len(self.replicas)
            self._rr += 1
            return idx
        if self.policy == "least_loaded":
            loads = [self._load(rt) for rt in self.replicas]
            return int(np.argmin(loads))
        return self._affinity_hash(prompt) % len(self.replicas)

    # ------------------------------------------------------------ lifecycle

    def submit(self, prompt, max_new: int = 16,
               arrival_s=None, klass: str = "uniform", slo: str = "batch"):
        """Route one request. Under an ``OverloadPolicy`` with a queue cap,
        an over-cap arrival is held at the router: deferred classes park in
        the backlog (arrival stamp preserved — the deferral is measured
        queueing in their TTFT), the rest are shed. Held requests return an
        ``_AdmissionHandle`` instead of a ``RequestHandle``."""
        if arrival_s is None:
            # a router-dispatched request arrives at the fleet's current
            # decision point: an idle (lagging) target cursor fast-forwards
            # to it instead of booking link transfers in its virtual past
            arrival_s = self.now_s
        pol = self.slo_policy
        if pol is not None:
            cap = pol.cap(slo)
            if cap and self._queued_class(slo) >= cap:
                self._held_rid -= 1
                req = Request(self._held_rid, list(prompt), max_new,
                              klass=klass or "uniform", slo=slo or "batch",
                              submitted_v=float(arrival_s))
                h = _AdmissionHandle(self, req)
                if pol.defers(slo):
                    req.status = "deferred"
                    self._backlog.setdefault(slo, deque()).append(
                        (h, list(prompt), max_new, float(arrival_s), klass))
                    self.deferred += 1
                else:
                    req.status = "shed"
                    self.shed += 1
                    self.shed_by_class[slo] = \
                        self.shed_by_class.get(slo, 0) + 1
                return h
        return self._dispatch(prompt, max_new, arrival_s, klass, slo)

    def _dispatch(self, prompt, max_new, arrival_s, klass,
                  slo) -> RequestHandle:
        rt = self.replicas[self.select_replica(prompt)]
        return rt.submit(prompt, max_new, arrival_s=arrival_s, klass=klass,
                         slo=slo)

    def _drain_backlog(self) -> None:
        """Dispatch deferred requests whose class queue dropped below cap
        (FIFO within a class; the ORIGINAL arrival stamp rides along, so
        the backlog wait lands in the request's measured TTFT)."""
        pol = self.slo_policy
        for slo, dq in self._backlog.items():
            cap = pol.cap(slo)
            while dq and (not cap or self._queued_class(slo) < cap):
                h, prompt, max_new, arrival_s, klass = dq.popleft()
                h._bind(self._dispatch(prompt, max_new, arrival_s, klass,
                                       slo))

    @property
    def now_s(self) -> float:
        """The fleet's decision point on the virtual timeline: the
        earliest busy replica (it takes the next wave); idle fleets sit
        at the furthest cursor."""
        busy = [rt.now_s for rt in self.replicas if rt.busy]
        return min(busy) if busy else self.clock.now_s

    def advance_to(self, t_s: float) -> None:
        """Fast-forward every idle replica to a future arrival."""
        for rt in self.replicas:
            if not rt.busy:
                rt.advance_to(t_s)

    def rebalance(self) -> int:
        """Continuous re-dispatch: migrate queued requests off the most
        backlogged replica onto the least loaded one while their load gap
        exceeds ``redispatch_skew`` — dispatch-time balance decays as
        completion times diverge mid-flight, and a queued request carries
        no replica state yet, so moving it is free. Newest queued requests
        move first (FIFO order on the donor is preserved). Only requests
        whose status is still ``"queued"`` are movable: a preempted or
        mid-spill request's KV pages live in the pool under its ORIGIN
        replica's bookings and slot claim — migrating it would strand
        them (and `_load` already charges the donor for it via
        ``_spilled``). Returns the number of migrations performed."""
        moved = 0
        while True:
            loads = [self._load(rt) for rt in self.replicas]
            # donor = most loaded replica that still has QUEUED requests
            # (a slot-saturated replica with an empty queue has nothing
            # movable, but another backlogged replica may)
            donors = [i for i, rt in enumerate(self.replicas)
                      if any(r.status == "queued" for r in rt.engine.queue)]
            if not donors:
                return moved
            src = max(donors, key=lambda i: loads[i])
            dst = int(np.argmin(loads))
            if loads[src] - loads[dst] < self.redispatch_skew:
                return moved
            rt_src, rt_dst = self.replicas[src], self.replicas[dst]
            req = next(r for r in reversed(rt_src.engine.queue)
                       if r.status == "queued")     # newest movable
            rt_src.engine.queue.remove(req)
            h = rt_src.handles.pop(req.rid, None)
            # the move happens at the later of the two cursors — a
            # migration cannot deliver work into a replica's past
            rt_dst.engine.cursor.advance_to(rt_src.now_s)
            rt_dst.engine.queue.append(req)
            if h is not None:
                h.runtime = rt_dst
                rt_dst.handles[req.rid] = h
            self.migrations += 1
            moved += 1

    def step(self) -> list[TokenEvent]:
        """One serving wave on every busy replica (lockstep DP emulation),
        preceded by a backlog-drain pass (deferred admissions whose class
        queue has room) and a re-dispatch pass when enabled."""
        if self.slo_policy is not None and any(self._backlog.values()):
            self._drain_backlog()
        if self.redispatch and len(self.replicas) > 1:
            self.rebalance()
        events: list[TokenEvent] = []
        for rt in self.replicas:
            if rt.busy:
                events.extend(rt.step())
        return events

    def cancel(self, handle: RequestHandle) -> bool:
        return handle.cancel()

    def drain(self) -> EngineStats:
        while self.busy:
            self.step()
        return self.stats().aggregate

    @property
    def busy(self) -> bool:
        return (any(rt.busy for rt in self.replicas)
                or any(self._backlog.values()))

    # ----------------------------------------------------------------- stats

    def stats(self) -> RouterStats:
        agg = EngineStats()
        per = {}
        for rt in self.replicas:
            agg.merge(rt.stats)
            per[rt.engine.name] = rt.stats
        cache = self.shared_cache.stats() if self.shared_cache is not None \
            else None
        pfx = self.prefix_cache.stats() if self.prefix_cache is not None \
            else None
        return RouterStats(aggregate=agg, per_replica=per, cache=cache,
                           migrations=self.migrations,
                           clock=self.clock.stats(), prefix_cache=pfx,
                           fabric=self.fabric.stats()
                           if self.fabric is not None else None,
                           shed=self.shed, deferred=self.deferred,
                           shed_by_class=dict(self.shed_by_class),
                           kv_pool=self.kv_pool.stats()
                           if self.kv_pool is not None else None)

    def store_stats(self) -> dict:
        """Per-replica `StoreStats` (each replica charges its own waves)."""
        return {rt.engine.name: rt.store.stats()
                for rt in self.replicas if rt.store is not None}
