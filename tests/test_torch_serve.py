"""PyTorch port vs the JAX reference: ``serve()`` on the CPU.

The serving API over a ``Workload`` (``ServeResult``, the arrival
processes, the fleet's prefix cache and fabric, SLO admission), the
``EngineStats`` rates of F7 and Table 2's headline check at the emulated
operating point: CXL within 0.95 of DRAM, with ``tokens_per_s_emulated``
equal to the reference's. On the tests' 3-layer deepseek-7b (Engram at
layer 1), with weights bridged from the reference, streams, rids and
counters are equal; at the emulated point (``emulate_step_s``) the virtual
clock, every TTFT and each store's stats are bit-identical. The reference's
drives are shared through a module fixture."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.models.model import init_params as ref_init_params  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro.serving import Router as RefRouter  # noqa: E402
from repro.serving import serve as ref_serve  # noqa: E402
from repro.serving import slo as ref_slo  # noqa: E402
from repro.serving import workload as ref_workload  # noqa: E402
from repro_torch.configs import deepseek_7b  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.serving import (Engine, EngineStats, OverloadPolicy,  # noqa: E402
                                 Router, SLOSpec, Workload, serve)

torch.set_num_threads(2)

# fields the host's clock sets, and the pad rows of the reference's
# power-of-two admission groups, which differ by design
EMULATED_UNSHARED = {"wall_s", "ttft_s_sum", "prefill_pad_tokens"}
KW = dict(max_batch=2, max_len=64, prompt_bucket=8)
PROMPTS = [[3, 17, 42, 9], [5, 11, 7], [2, 8, 20, 13, 4], [6, 9]]


def _tiny(mod):
    """The serving tests' config: 3 layers, Engram at layer 1."""
    cfg = mod.reduced()
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3,
                               engram=dataclasses.replace(cfg.engram,
                                                          layers=(1,)))


@pytest.fixture(scope="module")
def tiny():
    cfg, rcfg = _tiny(deepseek_7b), _tiny(ref_deepseek_7b)
    rparams = ref_init_params(rcfg, 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, rcfg, params, rparams


@pytest.fixture(scope="module")
def ref_runs(tiny):
    """Reference drives, each run once for the module."""
    _, rcfg, _, rparams = tiny
    cache = {}

    def get(name, fn):
        if name not in cache:
            cache[name] = fn(rcfg, rparams)
        return cache[name]
    return get


def _router(pkg_router, cfg, params, port, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("pool", "RDMA")
    for k, v in KW.items():
        kw.setdefault(k, v)
    if port:
        kw["device"] = "cpu"
    return pkg_router(cfg, params=params, **kw)


def _stats_equal(a, b, skip=EMULATED_UNSHARED):
    for f in dataclasses.fields(EngineStats):
        if f.name not in skip:
            assert getattr(a, f.name) == getattr(b, f.name), f.name


def _fleet_equal(port, ref, hp, hr):
    """At the emulated point: streams, rids, RouterStats, each replica's
    StoreStats, the clock and the fabric, field by field."""
    assert [h.tokens for h in hp] == [h.tokens for h in hr]
    assert [h.rid for h in hp] == [h.rid for h in hr]
    ps, rs = port.stats(), ref.stats()
    _stats_equal(ps.aggregate, rs.aggregate)
    assert list(ps.per_replica) == list(rs.per_replica)
    for name in ps.per_replica:
        _stats_equal(ps.per_replica[name], rs.per_replica[name])
    assert (ps.migrations, ps.shed, ps.deferred, ps.shed_by_class) == \
        (rs.migrations, rs.shed, rs.deferred, rs.shed_by_class)
    assert {n: dataclasses.asdict(s) for n, s in port.store_stats().items()} \
        == {n: dataclasses.asdict(s) for n, s in ref.store_stats().items()}
    assert ps.clock == rs.clock
    assert ps.fabric == rs.fabric


# --------------------------------------------- fleet serving (tests/test_
# prefill.py, tests/test_overload.py)


def test_fleet_shares_prefix_blocks(tiny, ref_runs):
    """tests/test_prefill.py: a fleet-wide prefix cache lets replica B
    restore blocks replica A prefilled; both replicas hit; output tokens
    equal the un-chunked fleet's and the reference's."""
    cfg, _, params, _ = tiny
    w = dict(requests=6, max_new=3, arrival="paced", arrival_every=3,
             prefix_pool=1, prefix_len=24, seed=0)
    kw = dict(pool="CXL", replicas=2, policy="round_robin",
              emulate_step_s=2e-4, **KW)
    base = serve(cfg, Workload(**w), params=params, device="cpu", **kw)
    shared = serve(cfg, Workload(**w), prefill_chunk=8,
                   prefix_cache_bytes=64 << 20, shared_prefix_cache=True,
                   params=params, device="cpu", **kw)
    assert [h.tokens for h in shared.handles] == \
        [h.tokens for h in base.handles]
    pfx = shared.router.stats().prefix_cache
    assert pfx is not None and pfx.hit_blocks > 0
    views = {name: st.prefix_hit_blocks
             for name, st in shared.router.stats().per_replica.items()}
    assert sum(1 for v in views.values() if v > 0) == 2, views
    ref = ref_runs("prefix", lambda rcfg, rparams: ref_serve(
        rcfg, ref_workload.Workload(**w), prefill_chunk=8,
        prefix_cache_bytes=64 << 20, shared_prefix_cache=True,
        params=rparams, **kw))
    _fleet_equal(shared.router, ref.router, shared.handles, ref.handles)
    assert dataclasses.asdict(pfx) == \
        dataclasses.asdict(ref.router.stats().prefix_cache)
    assert shared.ttft_v() == ref.ttft_v()
    assert shared.intertoken_gaps_v() == ref.intertoken_gaps_v()


def test_router_admission_shed_and_defer(tiny, ref_runs):
    """tests/test_overload.py: over-cap arrivals back-pressure into the
    router backlog (deferred) or are refused (shed), with the reference's
    per-class accounting, rids and streams."""
    def drive(pkg_router, pol, cfg, params, port):
        router = _router(pkg_router, cfg, params, port, replicas=1,
                         pool="CXL", emulate_step_s=2e-4, slo_policy=pol)
        hs = [router.submit(PROMPTS[i % len(PROMPTS)], 4, slo="batch")
              for i in range(4)]
        hs += [router.submit(PROMPTS[i], 4, slo="interactive")
               for i in range(3)]
        before = router.stats()
        held = [h.request.status for h in hs]
        router.drain()
        return router, hs, before, held

    pol = OverloadPolicy(queue_cap=1, defer_classes=("batch",),
                         preempt=False)
    router, hs, stats, held = drive(Router, pol, tiny[0], tiny[2], True)
    rpol = ref_slo.OverloadPolicy(queue_cap=1, defer_classes=("batch",),
                                  preempt=False)
    ref, hr, rstats, rheld = ref_runs("admission", lambda rcfg, rparams: drive(
        RefRouter, rpol, rcfg, rparams, False))
    assert (stats.deferred, stats.shed, stats.shed_by_class) == \
        (rstats.deferred, rstats.shed, rstats.shed_by_class)
    assert stats.deferred >= 1 and stats.shed >= 1
    assert stats.shed_by_class.get("interactive", 0) == stats.shed
    assert held == rheld
    shed = [h for h, st in zip(hs, held) if st == "shed"]
    deferred = [h for h, st in zip(hs, held) if st == "deferred"]
    assert shed and deferred
    assert all(h.rid < 0 for h in shed)
    # every deferred request was dispatched later and completed
    assert all(h.finished and h.request.rid > 0 for h in deferred)
    assert all(not h.tokens for h in shed)
    assert router.stats().shed == len(shed)
    assert [h.request.status for h in hs] == [h.request.status for h in hr]
    _fleet_equal(router, ref, hs, hr)


def test_serve_per_class_results_and_attainment(tiny, ref_runs):
    """tests/test_overload.py: per-class ttft_v/latency_v partition the
    global lists; slo_attainment is division-safe and counts shed requests
    as misses; every list equals the reference's."""
    cfg, _, params, _ = tiny

    def pol(mod):
        return mod.OverloadPolicy(
            slos={"interactive": mod.SLOSpec("interactive", ttft_s=5e-3,
                                             priority=10),
                  "batch": mod.SLOSpec("batch", ttft_s=1.0)},
            preempt=False)
    w = dict(requests=10, max_new=4, arrival="mmpp", qps=3000.0,
             burst_factor=6.0, calm_s=0.02, burst_s=0.01,
             interactive_fraction=0.4, seed=11)
    kw = dict(pool="CXL", replicas=1, emulate_step_s=2e-4, **KW)
    res = serve(cfg, Workload(**w), params=params, device="cpu",
                slo_policy=OverloadPolicy(slos={
                    "interactive": SLOSpec("interactive", ttft_s=5e-3,
                                           priority=10),
                    "batch": SLOSpec("batch", ttft_s=1.0)}, preempt=False),
                **kw)
    ref = ref_runs("mmpp", lambda rcfg, rparams: ref_serve(
        rcfg, ref_workload.Workload(**w), params=rparams,
        slo_policy=pol(ref_slo), **kw))
    assert len(res.ttft_v("interactive")) + len(res.ttft_v("batch")) \
        == len(res.ttft_v())
    assert len(res.latency_v("interactive")) + len(res.latency_v("batch")) \
        == len(res.latency_v())
    for klass in ("interactive", "batch", "no-such-class"):
        assert 0.0 <= res.slo_attainment(klass) <= 1.0
        assert res.slo_attainment(klass) == ref.slo_attainment(klass)
        assert res.ttft_v(klass) == ref.ttft_v(klass)
        assert res.latency_v(klass) == ref.latency_v(klass)
    assert res.slo_attainment("no-such-class") == 0.0
    assert res.slo_attainment("batch", ttft_s=1e9) == 1.0
    assert [h.tokens for h in res.handles] == [h.tokens for h in ref.handles]
    _stats_equal(res.stats, ref.stats)


def test_fleet_shares_one_fabric(tiny, ref_runs):
    """tests/test_overload.py: a router fleet shares ONE 4-node fabric;
    both replicas' waves cross its one switch port. At the emulated point
    the fabric's links, the clock and each replica's store equal the
    reference's."""
    cfg, _, params, _ = tiny
    w = dict(requests=6, max_new=4, arrival="poisson", qps=2000.0, seed=3)
    kw = dict(pool="CXL", replicas=2, max_batch=2, max_len=32,
              prompt_bucket=8, emulate_step_s=2e-4, fabric_nodes=4)
    res = serve(cfg, Workload(**w), params=params, device="cpu", **kw)
    router = res.router
    assert router.fabric is not None
    assert all(rt.engine.fabric is router.fabric for rt in router.replicas)
    fs = router.stats().fabric
    assert fs is not None and fs["n_nodes"] == 4
    sw = fs["links"]["fabric:switch"]
    assert sw["reservations"] > 0 and sw["bytes"] > 0
    assert len(res.ttft_v()) == 6
    ref = ref_runs("fabric", lambda rcfg, rparams: ref_serve(
        rcfg, ref_workload.Workload(**w), params=rparams, **kw))
    _fleet_equal(router, ref.router, res.handles, ref.handles)
    assert res.ttft_v() == ref.ttft_v()


# ------------------------------------ tests/test_clock.py, test_runtime.py


def test_poisson_ttft_grows_with_offered_load(tiny, ref_runs):
    """Virtual TTFT is deterministic, equals the reference's, and rises
    with QPS: at saturation requests queue on the virtual timeline."""
    cfg, _, params, _ = tiny
    kw = dict(pool="CXL", max_batch=2, max_len=32, prompt_bucket=8,
              emulate_step_s=2e-4)

    wl = dict(requests=8, max_new=4, arrival="poisson", seed=1)

    def drive(qps):
        return serve(cfg, Workload(qps=qps, **wl), params=params,
                     device="cpu", **kw)

    lo, hi = drive(200.0), drive(50_000.0)
    t_lo, t_hi = lo.ttft_v(), hi.ttft_v()
    assert len(t_lo) == len(t_hi) == 8
    assert all(t >= 0 for t in t_lo)
    assert np.median(t_hi) > np.median(t_lo)
    assert lo.stats.v_time_s > 0
    assert hi.stats.mean_ttft_v > lo.stats.mean_ttft_v
    assert drive(50_000.0).ttft_v() == t_hi
    for qps, res in ((200.0, lo), (50_000.0, hi)):
        ref = ref_runs(f"poisson{qps}", lambda rcfg, rparams: ref_serve(
            rcfg, ref_workload.Workload(qps=qps, **wl), params=rparams,
            **kw))
        assert res.ttft_v() == ref.ttft_v()
        assert res.latency_v() == ref.latency_v()
        assert [h.tokens for h in res.handles] == \
            [h.tokens for h in ref.handles]
        _stats_equal(res.stats, ref.stats)
        assert res.runtime.engine.clock.stats() == \
            ref.runtime.engine.clock.stats()


def test_serve_api_batch_and_paced(tiny):
    cfg, _, params, _ = tiny
    res = serve(cfg, Workload(requests=3, max_new=3), params=params,
                device="cpu", **KW)
    assert res.stats.requests_completed == 3
    assert all(h.finished for h in res.handles)
    assert res.stats.generated_tokens == 9
    paced = Workload(requests=3, max_new=3, arrival="paced",
                     arrival_every=2)
    res2 = serve(cfg, paced, params=params, device="cpu", max_batch=1,
                 max_len=64, prompt_bucket=8)
    assert res2.stats.requests_completed == 3
    # paced arrivals on one slot: later requests joined after earlier ones
    reqs = sorted(res2.runtime.done.values(), key=lambda r: r.rid)
    assert reqs[0].done_s <= reqs[1].first_token_s
    assert [h.tokens for h in res2.handles] == [h.tokens for h in res.handles]
    with pytest.raises(AssertionError, match="single-replica"):
        res.router


def test_rate_properties_division_safe(tiny):
    """Every EngineStats rate property, F7's included, is a finite 0.0 on
    fresh and reset engines and on pathological timer values."""
    cfg, _, params, _ = tiny
    rate_props = [n for n, v in vars(EngineStats).items()
                  if isinstance(v, property)]
    assert set(rate_props) >= {"tokens_per_s", "tokens_per_s_emulated",
                               "acceptance_rate", "tokens_per_step",
                               "requests_per_s", "mean_ttft_s",
                               "pad_row_fraction"}

    def check(stats):
        for name in rate_props:
            val = getattr(stats, name)
            assert isinstance(val, float) and np.isfinite(val), (name, val)
            assert val == 0.0, (name, val)

    check(EngineStats())
    eng = Engine(cfg, params=params, max_batch=1, max_len=32,
                 prompt_bucket=8, device="cpu")
    check(eng.stats)
    eng.submit([5, 6, 7], max_new=2)
    eng.run()
    assert eng.stats.tokens_per_s > 0.0 and eng.stats.requests_per_s > 0.0
    eng.reset_stats()
    check(eng.stats)
    check(EngineStats(wall_s=float("nan"), emu_time_s=-1.0))


def test_engine_stats_merge_matches_reference():
    """``merge`` adds counters, takes the max of the three clock fields and
    merges the per-class dicts key by key, as the reference's does."""
    from repro.serving import EngineStats as RefEngineStats
    vals = [dict(decode_steps=3, generated_tokens=24, wall_s=1.5,
                 emu_time_s=0.25, v_time_s=2.0, stall_s=0.1,
                 prefill_pad_tokens=4, prefill_tokens=12,
                 requests_completed=3,
                 spec_by_class={"zipf": {"proposed": 4, "accepted": 2}}),
            dict(decode_steps=5, generated_tokens=40, wall_s=1.0,
                 emu_time_s=0.5, v_time_s=1.0, stall_s=0.2,
                 prefill_tokens=20, requests_completed=5,
                 spec_by_class={"zipf": {"proposed": 1},
                                "uniform": {"accepted": 3}})]
    got, want = EngineStats(), RefEngineStats()
    for v in vals:
        assert got.merge(EngineStats(**v)) is got
        want.merge(RefEngineStats(**v))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.wall_s, got.emu_time_s, got.v_time_s) == (1.5, 0.5, 2.0)
    assert got.generated_tokens == 64
    assert got.spec_by_class == {"zipf": {"proposed": 5, "accepted": 2},
                                 "uniform": {"accepted": 3}}
    for name in ("tokens_per_s", "tokens_per_s_emulated", "requests_per_s",
                 "pad_row_fraction"):
        assert getattr(got, name) == getattr(want, name), name


# ----------------------------------- Table 2 (tests/test_serving.py)


def test_pool_tiers_rank_by_throughput(tiny, ref_runs):
    """At the emulated point (50 us steps) RDMA overshoots the prefetch
    window while DRAM and CXL hide; CXL serves within 0.95 of DRAM. Every
    ``tokens_per_s_emulated`` equals the reference's."""
    cfg, _, params, _ = tiny
    kw = dict(max_batch=2, max_len=32, prompt_bucket=8, emulate_step_s=5e-5)

    def drive(eng):
        for i in range(3):
            eng.submit([1, 2, 3 + i], max_new=4)
        return eng.run()

    outs = {pool: drive(Engine(cfg, params=params, pool=pool, device="cpu",
                               **kw))
            for pool in ("DRAM", "CXL", "RDMA")}
    assert outs["DRAM"].stall_s == 0.0
    assert outs["CXL"].stall_s == 0.0
    assert outs["RDMA"].stall_s > 0.0
    assert (outs["CXL"].tokens_per_s_emulated
            > outs["RDMA"].tokens_per_s_emulated)
    assert (outs["CXL"].tokens_per_s_emulated
            > 0.95 * outs["DRAM"].tokens_per_s_emulated)
    for pool, st in outs.items():
        ref = ref_runs(f"tier{pool}", lambda rcfg, rparams: drive(
            RefEngine(rcfg, params=rparams, pool=pool, **kw)))
        assert st.tokens_per_s_emulated == ref.tokens_per_s_emulated, pool
        _stats_equal(st, ref)
