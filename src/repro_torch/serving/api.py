"""`serve(cfg, workload, ...)`: the one config-driven serving entry point.

The simulator's measured DP scenario (``pool.simulator.
measured_scalability``) calls this, as the reference's CLI, examples and
benchmarks call the reference's ``serve``. A `Workload`
(serving/workload.py) describes the traffic, `replicas` decides between a
single `EngramRuntime` and a `Router` fleet, and the arrival process is
honoured by interleaving submission with `step()` — paced workloads join
mid-flight, the way real traffic meets a pool.

PyTorch port of ``repro.serving.api``: ``device`` (an engine kwarg) reaches
every replica's ``Engine``; the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from ..pool.cache import PrefixKVCache
from .engine import EngineStats
from .router import Router
from .runtime import EngramRuntime
from .slo import DEFAULT_SLOS, OverloadPolicy
from .workload import Workload


@dataclasses.dataclass
class ServeResult:
    """Outcome of one `serve()` drive."""
    frontend: Union[EngramRuntime, Router]
    handles: list                      # per request, submission order
    stats: EngineStats                 # aggregate over replicas
    slo_policy: Optional[OverloadPolicy] = None   # the run's policy

    @property
    def router(self) -> Router:
        assert isinstance(self.frontend, Router), "single-replica run"
        return self.frontend

    @property
    def runtime(self) -> EngramRuntime:
        assert isinstance(self.frontend, EngramRuntime), "router run"
        return self.frontend

    def store_stats(self):
        """Single replica: its `StoreStats` (or None). Router: the
        per-replica dict (shared-cache stats live on `router.stats()`)."""
        if isinstance(self.frontend, Router):
            return self.frontend.store_stats()
        store = self.frontend.store
        return store.stats() if store is not None else None

    def ttft_v(self, klass: Optional[str] = None) -> list:
        """Per-request virtual TTFT (offered-load arrival -> first token
        on the fleet clock), submission order, admitted requests only.
        ``klass`` filters to one SLO class (serving/slo.py) — the
        per-class percentile bench_overload's attainment gate reads."""
        return [h.request.first_token_v - h.request.submitted_v
                for h in self.handles if h.request.first_token_v > 0.0
                and (klass is None or h.request.slo == klass)]

    def latency_v(self, klass: Optional[str] = None) -> list:
        """Per-request virtual end-to-end latency (arrival -> last
        token), completed requests only; ``klass`` filters to one SLO
        class."""
        return [h.request.done_v - h.request.submitted_v
                for h in self.handles if h.finished
                and (klass is None or h.request.slo == klass)]

    def slo_attainment(self, klass: str,
                       ttft_s: Optional[float] = None) -> float:
        """Fraction of the class's SUBMITTED requests whose virtual TTFT
        met the target — shed and never-admitted requests count as misses
        (an SLO refused is an SLO not met; attainment over admitted
        requests only would reward shedding). ``ttft_s`` defaults to the
        run's policy spec (or the DEFAULT_SLOS table). Division-safe:
        a class with no requests reports 0.0."""
        reqs = [h.request for h in self.handles if h.request.slo == klass]
        if not reqs:
            return 0.0
        if ttft_s is None:
            spec = self.slo_policy.spec(klass) \
                if self.slo_policy is not None else DEFAULT_SLOS.get(klass)
            ttft_s = spec.ttft_s if spec is not None else 0.0
        met = sum(1 for r in reqs if r.first_token_v > 0.0
                  and r.first_token_v - r.submitted_v <= ttft_s)
        return met / len(reqs)

    def intertoken_gaps_v(self) -> list:
        """Per-request virtual inter-token gaps (consecutive emission-
        stamp diffs), concatenated over all requests — the decode-
        smoothness distribution whose p99 a monolithic group prefill
        inflates and chunked prefill bounds."""
        gaps = []
        for h in self.handles:
            st = h.request.stamps
            gaps.extend(b - a for a, b in zip(st, st[1:]))
        return gaps


def _engines(frontend) -> list:
    if isinstance(frontend, Router):
        return [rt.engine for rt in frontend.replicas]
    return [frontend.engine]


def serve(cfg, workload: Workload, *, pool=None, replicas: int = 1,
          policy: str = "round_robin", shared_cache: bool = True,
          warmup: bool = False, **engine_kwargs) -> ServeResult:
    """Drive `workload` against `cfg` served from `pool`.

    ``replicas=1`` builds an `EngramRuntime`; ``replicas>1`` a `Router`
    (with `policy` dispatch and, when the config carries cache rows, one
    `shared_cache` across the fleet). All other kwargs reach `Engine`.
    Requests are submitted when their arrival comes up — a serving step
    for `batch`/`paced` workloads, a *virtual-clock* instant for
    `poisson` offered load (an idle fleet fast-forwards to the next
    arrival; a busy one meets it mid-flight) — interleaved with
    `step()`s, then the fleet is drained.

    ``prefix_cache_bytes`` / ``shared_prefix_cache`` (engine_kwargs,
    intercepted here): mount a prefix KV cache over chunk-boundary
    prefill snapshots — one fleet-wide cache by default, private
    per-replica caches with ``shared_prefix_cache=False``; a single
    replica always gets its own. Needs ``prefill_chunk``.

    ``fabric_nodes`` (engine_kwargs): shard the pool over that many
    nodes behind one CXL switch (pool/fabric.PoolFabric). A router fleet
    shares ONE fabric (the Router intercepts it as a named parameter); a
    single replica builds its own. ``result.frontend.fabric`` (router)
    or ``result.frontend.engine.fabric`` exposes it for failure drills.

    ``slo_policy`` / ``arbiter`` (engine_kwargs, intercepted here): the
    overload-survival stack (serving/slo.py, pool/kvpool.py) — SLO-class
    admission control (router), priority dispatch + preemption with KV
    spill (engine), KV-vs-Engram link/cache arbitration. Workload specs'
    ``slo`` tags ride into every submitted request, and the result's
    ``ttft_v(klass)`` / ``slo_attainment(klass)`` read the outcome.
    """
    specs = workload.build(cfg.vocab_size)
    prefix_cache_bytes = int(engine_kwargs.pop("prefix_cache_bytes", 0))
    shared_prefix_cache = bool(engine_kwargs.pop("shared_prefix_cache",
                                                 True))
    slo_policy = engine_kwargs.pop("slo_policy", None)
    arbiter = engine_kwargs.pop("arbiter", None)
    if replicas > 1:
        frontend: Union[EngramRuntime, Router] = Router(
            cfg, replicas=replicas, pool=pool, policy=policy,
            shared_cache=shared_cache,
            prefix_cache_bytes=prefix_cache_bytes,
            shared_prefix_cache=shared_prefix_cache,
            slo_policy=slo_policy, arbiter=arbiter, **engine_kwargs)
    else:
        if prefix_cache_bytes > 0:
            chunk = engine_kwargs.get("prefill_chunk")
            assert chunk, "prefix_cache_bytes needs prefill_chunk"
            engine_kwargs["prefix_cache"] = PrefixKVCache(
                prefix_cache_bytes, chunk)
        frontend = EngramRuntime(cfg, pool=pool, slo_policy=slo_policy,
                                 arbiter=arbiter, **engine_kwargs)
    if warmup:
        for eng in _engines(frontend):
            eng.warmup()

    def due(spec, step_no: int) -> bool:
        if spec.arrival_s is not None:
            return spec.arrival_s <= frontend.now_s
        return spec.arrival_step <= step_no

    handles = []
    i, step_no = 0, 0
    while i < len(specs) or frontend.busy:
        if (not frontend.busy and i < len(specs)
                and specs[i].arrival_s is not None):
            # idle fleet, future offered-load arrival: jump the clock
            frontend.advance_to(specs[i].arrival_s)
        while i < len(specs) and due(specs[i], step_no):
            handles.append(frontend.submit(list(specs[i].prompt),
                                           specs[i].max_new,
                                           arrival_s=specs[i].arrival_s,
                                           klass=specs[i].klass,
                                           slo=specs[i].slo))
            i += 1
        if frontend.busy:
            frontend.step()
        step_no += 1
    if isinstance(frontend, Router):
        stats = frontend.stats().aggregate
    else:
        stats = frontend.stats
    return ServeResult(frontend=frontend, handles=handles, stats=stats,
                       slo_policy=slo_policy)
