"""Retrieval-latency + end-to-end throughput simulator.

Reproduces the paper's measurements with the calibrated tier models:
  * Figs 3/5/6 — Engram-27B/40B read latency vs retrieval batch size for
    DRAM / CXL / RDMA (CPU path) and the CXL->GPU path.
  * Tables 2/3 — end-to-end decode throughput with Engram offloaded to a
    tier: the retrieval either hides inside the prefetch window (zero
    cost) or stalls the step by the overshoot.

A copy of ``repro.pool.simulator`` over the port's store, scheduler and
clock: the PyTorch port imports nothing of the JAX package. It computes
on the host (Python and numpy), as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import EngramConfig
from .feasibility import ServingPoint
from .store import CachedStore, TierStore, segment_bytes, segment_count
from .tiers import TierSpec, TIERS


def read_latency_s(ecfg: EngramConfig, tier: TierSpec, batch_tokens: int,
                   gpu_path: bool = False) -> float:
    """Latency to read one Engram layer's embeddings for ``batch_tokens``.

    Delegates to the ``EngramStore`` tier backend — the same code path the
    serving engine charges, so tables and engine cannot drift apart."""
    lat = TierStore(ecfg, tier).read_latency_s(batch_tokens)
    if gpu_path:
        # P2P wide-grid kernel: one launch (~8 us) + PCIe transfer
        n_segments = segment_count(ecfg, batch_tokens)
        lat = lat + 8e-6 + n_segments * segment_bytes(ecfg) / 55e9
    return lat


def latency_sweep(ecfg: EngramConfig, batch_sizes=(1, 8, 32, 64, 128, 256,
                                                   512, 1024),
                  tiers=("DRAM", "CXL", "RDMA")) -> dict:
    """Figure 3/5/6 data: {tier: [(batch, latency_us), ...]}."""
    out = {}
    for t in tiers:
        tier = TIERS[t]
        out[t] = [(b, read_latency_s(ecfg, tier, b) * 1e6)
                  for b in batch_sizes]
    out["CXL->GPU"] = [(b, read_latency_s(ecfg, TIERS["CXL"], b,
                                          gpu_path=True) * 1e6)
                       for b in batch_sizes]
    return out


def cached_read_latency_s(ecfg: EngramConfig, backing: TierSpec,
                          batch_tokens: int, hit_rate: float,
                          cache_tier: TierSpec | None = None) -> float:
    """Paper §6 (Discussion): a DRAM cache of 'hot' Engram rows in front of
    a slower backing tier. Zipf-distributed n-gram reuse makes high hit
    rates realistic; misses pay the backing tier on their own (smaller)
    batch. Latency = max(hit path, miss path) — both proceed in parallel.

    Analytic entry point to ``CachedStore``: the same split-latency code
    the serving engine charges with *measured* hit rates, evaluated here
    at an assumed one."""
    from .tiers import DRAM
    store = CachedStore(TierStore(ecfg, backing),
                        cache_tier=cache_tier or DRAM)
    return store.ideal_latency_s(batch_tokens, hit_rate)


def rdma_rescue_sweep(ecfg: EngramConfig, point: "ServingPoint",
                      hit_rates=(0.0, 0.5, 0.8, 0.9, 0.95, 0.99)) -> list:
    """Paper §6 quantified: can hot-row DRAM caching and/or payload
    aggregation make RDMA fit the Engram prefetch window?"""
    from .feasibility import prefetch_window_s
    from .tiers import RDMA, RDMA_AGG
    window = prefetch_window_s(point, min(ecfg.layers))
    out = []
    for h in hit_rates:
        lat = cached_read_latency_s(ecfg, RDMA, point.batch_tokens, h)
        lat_agg = cached_read_latency_s(ecfg, RDMA_AGG, point.batch_tokens, h)
        out.append({"hit_rate": h, "latency_us": lat * 1e6,
                    "latency_agg_us": lat_agg * 1e6,
                    "window_us": window * 1e6, "fits": lat < window,
                    "fits_agg": lat_agg < window})
    return out


@dataclasses.dataclass(frozen=True)
class ThroughputResult:
    config: str
    tokens_per_s: float
    stall_s_per_step: float
    hidden: bool                      # retrieval fully inside the window


def engram_step_overhead_s(ecfg: EngramConfig, point: ServingPoint,
                           tier: TierSpec, compute_overhead_s: float) -> tuple:
    """Per-decode-step cost of Engram: fixed compute (gating/proj) +
    any retrieval overshoot beyond each layer's prefetch window.

    Charged by the same ``PrefetchScheduler`` the serving engine runs —
    the analytic tables and the engine share one stall formula, evaluated
    on one (fresh, uncontended) ``VirtualClock`` timeline. The paper's
    1-indexed convention (layer k gets k-1 layers of window) maps to the
    scheduler's 0-indexed windows via ``k - 1``."""
    from ..serving.clock import VirtualClock
    from .scheduler import PrefetchScheduler
    clock = VirtualClock()
    store = TierStore(ecfg, tier, clock=clock)
    store.bind_cursor(clock.cursor("sim"))
    sched = PrefetchScheduler(store, ecfg,
                              layers=[max(k - 1, 0) for k in ecfg.layers],
                              n_layers=point.n_layers)
    report = sched.step(point.batch_tokens, point.step_latency_s)
    return compute_overhead_s + report.stall_s, report.hidden


def _replay_segments(entry):
    """Trace split entry -> ``Segments``: ``(hits, misses)`` or the
    fabric-recorded ``(hits, misses, shards)``."""
    from .store import Segments
    return Segments(entry[0], entry[1],
                    shards=entry[2] if len(entry) > 2 else None)


def _replay_rig(ecfg: EngramConfig, tier, clock, name: str, *, layers,
                n_layers, store_cfg=None, fabric=None, cache_link=None):
    """A fresh clock-bound store and scheduler to replay one engine's
    trace on ``clock``: -> (cursor, scheduler)."""
    from .scheduler import PrefetchScheduler
    from .store import make_store
    cursor = clock.cursor(name)
    store = make_store(ecfg, tier, store_cfg=store_cfg, clock=clock,
                       cache_link=cache_link, fabric=fabric)
    store.bind_cursor(cursor)
    return cursor, PrefetchScheduler(store, ecfg, layers=layers,
                                     n_layers=n_layers)


def _replay_wave(cursor, sched, wave) -> float:
    """Charge one recorded wave again at its virtual issue time; -> its
    stall."""
    from .scheduler import SpecTraceWave
    cursor.advance_to(wave.issued_at_s)
    cursor.next_wave()
    if isinstance(wave, SpecTraceWave):
        report = sched.speculative_wave(
            [[_replay_segments(e) for e in per_layer]
             for per_layer in wave.splits],
            wave.step_s, early_issue_s=wave.early_issue_s)
        return sched.charge_spec(report, wave.n_keep,
                                 tokens_emitted=wave.n_keep)
    return sched.step([_replay_segments(e) for e in wave.split],
                      wave.step_s).stall_s


def replay_stall_s(ecfg: EngramConfig, tier, trace, *, layers, n_layers,
                   store_cfg=None, clock=None,
                   fabric_nodes=None) -> float:
    """Replay an engine-recorded wave trace (``PrefetchScheduler.trace``)
    through a *fresh* clock-bound store + scheduler — the simulator's
    prediction of the stall time the engine measured.

    Because engine and simulator share one code path (store latency model,
    scheduler windows, clock link queueing), the prediction must agree
    bit-for-bit with the engine's ``stall_s`` on the same trace — the
    regression contract tests/test_clock.py pins down. ``trace`` entries
    carry the virtual issue time, step latency, and per-layer
    (hits, misses[, shards]) split of each charged wave; speculative
    waves (``SpecTraceWave``) additionally carry the per-position splits,
    the verified surviving-position count, and the pipelined early-issue
    credit, and are re-charged through the same ``speculative_wave`` +
    ``charge_spec`` pair the engine ran.

    ``fabric_nodes``: replay a fabric-backed run — the store mounts a
    fresh ``PoolFabric`` of that many nodes (static placement; the
    no-failure replay contract) and the recorded per-shard splits drive
    the same multi-node charge."""
    from ..serving.clock import VirtualClock
    clock = clock if clock is not None else VirtualClock()
    fabric = None
    if fabric_nodes:
        from .fabric import PoolFabric
        from .tiers import pool_tier
        # a chain spec shards its WARM level over the fabric (the cold
        # tier keeps its own link inside the chain store)
        ftier = pool_tier(tier) if isinstance(tier, str) else tier
        fabric = PoolFabric(ecfg, int(fabric_nodes), tier=ftier,
                            clock=clock)
    cursor, sched = _replay_rig(ecfg, tier, clock, "replay", layers=layers,
                                n_layers=n_layers, store_cfg=store_cfg,
                                fabric=fabric)
    total = 0.0
    for wave in trace:
        total += _replay_wave(cursor, sched, wave)
    return total


def replay_fleet_stall_s(ecfg: EngramConfig, tier, traces, order, *, layers,
                         n_layers, store_cfg=None,
                         shared_cache: bool = False) -> list:
    """Replay a ``Router`` fleet's wave traces (one per replica, in replica
    order) on ONE fresh clock, interleaved as the fleet charged them:
    ``order[i]`` is the index of the replica whose wave was the i-th the
    fleet charged. At the emulated point the router's replicas share the
    pool tier's link, and with a shared hot-row cache one ``cache:shared``
    link for their hits (``shared_cache``); so a replica's stall includes
    the waits the other replicas' transfers caused, which
    ``replay_stall_s`` of its trace alone cannot see. -> each replica's
    replayed stall, bit-equal to its engine's ``stall_s``.

    The reference has no fleet replay; this is ``replay_stall_s``'s fleet
    twin, over the same store, scheduler and clock code."""
    from ..serving.clock import VirtualClock
    order = [int(r) for r in order]
    counts = [order.count(r) for r in range(len(traces))]
    assert counts == [len(t) for t in traces], (counts, len(order))
    clock = VirtualClock()
    cache_link = None
    if shared_cache:
        scfg = store_cfg if store_cfg is not None else ecfg.store
        cache_link = clock.link("cache:shared",
                                TIERS[scfg.cache_tier].bandwidth_Bps)
    rigs = [_replay_rig(ecfg, tier, clock, f"replica{r}", layers=layers,
                        n_layers=n_layers, store_cfg=store_cfg,
                        cache_link=cache_link)
            for r in range(len(traces))]
    waves = [iter(t) for t in traces]
    stalls = [0.0] * len(traces)
    for r in order:
        stalls[r] += _replay_wave(*rigs[r], next(waves[r]))
    return stalls


# ---------------------------------------------------------------------------
# three-level placement solver (pool/tierchain.py's analytic twin)
# ---------------------------------------------------------------------------

def chain_hit_fractions(front_rows: int, warm_rows: int, total_rows: int,
                        alpha: float) -> tuple[float, float, float]:
    """Steady-state (front, warm, cold) traffic fractions for a finite
    Zipf(``alpha``) key stream over ``total_rows`` distinct rows when the
    hottest ``front_rows`` live in the DRAM front and the next
    ``warm_rows`` in the warm partition (LRU + aged-TinyLFU placement
    converges to rank order on a stationary stream). Generalized harmonic
    sums: P(rank <= k) = H_alpha(k) / H_alpha(total)."""
    total = max(1, int(total_rows))
    front = min(max(0, int(front_rows)), total)
    warm = min(max(0, int(warm_rows)), total - front)
    w = np.arange(1, total + 1, dtype=np.float64) ** -float(alpha)
    cum = np.cumsum(w)
    h_total = float(cum[-1])
    p_front = float(cum[front - 1]) / h_total if front else 0.0
    p_fw = float(cum[front + warm - 1]) / h_total if front + warm else 0.0
    return p_front, p_fw - p_front, 1.0 - p_fw


def predict_chain_ttft_s(ecfg: EngramConfig, *, front_rows: int,
                         warm_rows: int, total_rows: int, alpha: float,
                         batch_tokens: int, step_s: float, layers,
                         n_layers: int, ttft_steps: int = 1,
                         levels=("DRAM", "CXL", "SSD")) -> float:
    """Predicted admission-wave TTFT for one placement: ``ttft_steps``
    emulated steps (1 = the bare prefill wave; the monolithic-admission
    serving path emits its first token one decode wave later, so
    ``serve()`` comparisons use 2) plus each Engram layer's window
    overshoot on the admission wave, with the
    wave's expected segment counts split over the chain by
    ``chain_hit_fractions`` and the three levels fetched in parallel
    (``TierChain``'s max-of-paths charge; the cold level is an aggregate
    tier, so its count prices as ONE scatter-gather payload). This is the
    model the placement solver optimizes and bench_tiering validates
    against measured ``serve()`` TTFT."""
    p_f, p_w, _ = chain_hit_fractions(front_rows, warm_rows, total_rows,
                                      alpha)
    n = segment_count(ecfg, batch_tokens)
    seg = segment_bytes(ecfg)
    n_f = int(round(n * p_f))
    n_w = int(round(n * p_w))
    n_c = max(0, n - n_f - n_w)
    lat = 0.0
    for count, name in ((n_f, levels[0]), (n_w, levels[1]),
                        (n_c, levels[2])):
        if count > 0:
            lat = max(lat, TIERS[name].read_latency_s(count, seg))
    stall = sum(max(0.0, lat - k * step_s / max(1, int(n_layers)))
                for k in layers)
    return max(1, int(ttft_steps)) * step_s + stall


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """One evaluated DRAM/CXL/SSD split."""
    front_rows: int
    warm_rows: int
    cold_rows: int
    ttft_s: float                     # predicted admission-wave TTFT
    cost_usd: float
    feasible: bool                    # meets the TTFT target

    @property
    def split(self) -> tuple[int, int, int]:
        return self.front_rows, self.warm_rows, self.cold_rows


def _chain_plan(ecfg, front: int, warm: int, *, total_rows, alpha,
                batch_tokens, step_s, ttft_target_s, layers, n_layers,
                nodes, prices, levels, ttft_steps=1) -> PlacementPlan:
    from .cost import DEFAULT_PRICES, chain_cost
    seg = segment_bytes(ecfg)
    cold = max(0, int(total_rows) - front - warm)
    ttft = predict_chain_ttft_s(
        ecfg, front_rows=front, warm_rows=warm, total_rows=total_rows,
        alpha=alpha, batch_tokens=batch_tokens, step_s=step_s,
        layers=layers, n_layers=n_layers, ttft_steps=ttft_steps,
        levels=levels)
    gb = seg / 1e9
    cost = chain_cost(front * gb, warm * gb, cold * gb, nodes=nodes,
                      prices=prices if prices is not None
                      else DEFAULT_PRICES)
    return PlacementPlan(front_rows=front, warm_rows=warm, cold_rows=cold,
                         ttft_s=ttft, cost_usd=cost,
                         feasible=ttft <= ttft_target_s)


def _best_plan(plans: list) -> PlacementPlan:
    """Optimum under the shared objective: minimum cost among feasible
    plans, ties broken by lowest predicted TTFT then smallest split; when
    nothing meets the target, the lowest-TTFT (then cheapest) plan with
    ``feasible=False`` — solver and brute force share this exact rule, so
    their chosen splits must agree."""
    feas = [p for p in plans if p.feasible]
    if feas:
        return min(feas, key=lambda p: (p.cost_usd, p.ttft_s,
                                        p.front_rows, p.warm_rows))
    return min(plans, key=lambda p: (p.ttft_s, p.cost_usd,
                                     p.front_rows, p.warm_rows))


def placement_sweep(ecfg: EngramConfig, *, total_rows: int, alpha: float,
                    batch_tokens: int, step_s: float, ttft_target_s: float,
                    front_grid, warm_grid, layers, n_layers: int,
                    nodes: int = 1, prices=None, ttft_steps: int = 1,
                    levels=("DRAM", "CXL", "SSD")) -> list:
    """Brute force: evaluate EVERY (front, warm) grid point ->
    ``PlacementPlan`` list (the solver's ground truth)."""
    return [_chain_plan(ecfg, int(f), int(w), total_rows=total_rows,
                        alpha=alpha, batch_tokens=batch_tokens,
                        step_s=step_s, ttft_target_s=ttft_target_s,
                        layers=layers, n_layers=n_layers, nodes=nodes,
                        prices=prices, levels=levels,
                        ttft_steps=ttft_steps)
            for f in front_grid for w in warm_grid]


def plan_placement(ecfg: EngramConfig, *, total_rows: int, alpha: float,
                   batch_tokens: int, step_s: float, ttft_target_s: float,
                   front_grid, warm_grid, layers, n_layers: int,
                   nodes: int = 1, prices=None, ttft_steps: int = 1,
                   levels=("DRAM", "CXL", "SSD")) -> PlacementPlan:
    """Placement solver: the min-cost DRAM/CXL/SSD split meeting the TTFT
    target. Exploits monotone structure instead of the full grid:
    predicted TTFT is non-increasing and cost increasing in either
    capacity (cold is the cheapest $/GB), so per warm level a binary
    search over the ascending front grid finds the cheapest feasible
    front — O(W log F) model evaluations vs the sweep's O(W·F) — and the
    winner is the cheapest per-warm candidate under ``_best_plan``'s
    rule. Validated against ``placement_sweep`` by bench_tiering."""
    def plan(f, w):
        return _chain_plan(ecfg, int(f), int(w), total_rows=total_rows,
                           alpha=alpha, batch_tokens=batch_tokens,
                           step_s=step_s, ttft_target_s=ttft_target_s,
                           layers=layers, n_layers=n_layers, nodes=nodes,
                           prices=prices, levels=levels,
                           ttft_steps=ttft_steps)
    fronts = sorted(int(f) for f in front_grid)
    cands = []
    for w in warm_grid:
        lo, hi = 0, len(fronts) - 1
        if not plan(fronts[hi], w).feasible:      # nothing feasible here
            cands.append(plan(fronts[0], w))      # best-effort fallback
            continue
        while lo < hi:                            # first feasible front
            mid = (lo + hi) // 2
            if plan(fronts[mid], w).feasible:
                hi = mid
            else:
                lo = mid + 1
        cands.append(plan(fronts[lo], w))
    return _best_plan(cands)


def throughput_table(ecfg: EngramConfig, point: ServingPoint,
                     engram_compute_frac: float = 0.07) -> list:
    """Table 2 analogue: baseline vs +Engram(DRAM) vs +Engram(CXL) [+RDMA]."""
    base_tps = point.batch_tokens / point.step_latency_s
    rows = [ThroughputResult("baseline", base_tps, 0.0, True)]
    comp = engram_compute_frac * point.step_latency_s
    for t in ("DRAM", "CXL", "RDMA"):
        ovh, hidden = engram_step_overhead_s(ecfg, point, TIERS[t], comp)
        step = point.step_latency_s + ovh
        rows.append(ThroughputResult(f"+Engram ({t})",
                                     point.batch_tokens / step,
                                     ovh - comp, hidden))
    return rows


def measured_scalability(cfg, workload, *, dps=(1, 2), pool: str = "CXL",
                         policy: str = "round_robin", **engine_kwargs) -> list:
    """Measured counterpart of ``scalability_table``: the same Table 3
    DP-scaling question answered by actually serving ``workload`` from a
    Router fleet (serving/api.serve) instead of the analytic contention
    model. One row per DP degree: aggregate tokens, the fleet wall clock
    (slowest replica — replicas model parallel hardware), and the shared
    hot-row cache hit rate when the config carries cache rows.

    On one card the router steps its replicas one after another, so a
    row's ``wall_s`` and ``tokens_per_s`` (the merged stats: the slowest
    replica's wall time) are the parallel-hardware model, not what the
    card delivered: a DP speedup read off these rows was not measured.
    The drive's own host-clock time is the measurement."""
    from ..serving import Router, serve
    rows = []
    for dp in dps:
        res = serve(cfg, workload, pool=pool, replicas=dp, policy=policy,
                    **engine_kwargs)
        row = {"dp": dp, "tokens": res.stats.generated_tokens,
               "wall_s": res.stats.wall_s,
               "tokens_per_s": res.stats.tokens_per_s,
               "stall_s": res.stats.stall_s, "cache_hit_rate": 0.0}
        if isinstance(res.frontend, Router):
            row["cache_hit_rate"] = res.frontend.stats().cache_hit_rate
        elif res.store_stats() is not None:
            row["cache_hit_rate"] = res.store_stats().hit_rate
        rows.append(row)
    return rows


def scalability_table(ecfg: EngramConfig, point: ServingPoint,
                      dps=(1, 2), nnodes=(1, 2),
                      engram_compute_frac: float = 0.07,
                      dp_efficiency: float = 0.73,
                      node_overhead: float = 0.013,
                      pool_nodes=None) -> list:
    """Table 3 analogue: DP x nnode scaling.

    Semantics follow the paper's SGLang setup: ``dp`` is the number of
    model replicas (each a pool reader); ``nnode`` spreads them over more
    hosts — it does NOT add replicas, it only changes which CXL adapter
    each replica reads through and adds a small cross-node orchestration
    overhead (paper measures ~1-1.5%). DP replicas on one host share the
    host (CPU/PCIe) — the paper's DP=2 yields 1.46x, captured by
    ``dp_efficiency`` (calibrated to Table 3). The pool side contends on
    the shared switch (512 GB/s) and per-node adapters (56 GB/s).

    ``pool_nodes``: shard count on the *pool* side of the switch (the
    fabric's M) — the pool's aggregate adapter budget then caps the
    readers too. Default (None) assumes a pool node per reader host, the
    symmetric provisioning under which the pool side never binds (the
    Table 3 calibration)."""
    from .cost import contended_tier
    out = []
    for dp in dps:
        for nn in nnodes:
            # replicas split their host adapter and the shared switch —
            # the provisioned-bandwidth budget pool/cost.py owns
            tier = contended_tier(TIERS["CXL"], dp, nnodes=nn,
                                  pool_nodes=pool_nodes)
            comp = engram_compute_frac * point.step_latency_s
            ovh, hidden = engram_step_overhead_s(ecfg, point, tier, comp)
            step = point.step_latency_s + ovh
            if nn > 1:
                step *= 1.0 + node_overhead
            per_replica = point.batch_tokens / step
            scale = 1.0 if dp == 1 else dp * dp_efficiency
            out.append({
                "dp": dp, "nnode": nn,
                "pool_nodes": nn if pool_nodes is None else int(pool_nodes),
                "tokens_per_s": per_replica * scale,
                "per_replica_tps": per_replica,
                "hidden": hidden,
            })
    return out
