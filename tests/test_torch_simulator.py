"""PyTorch port vs the JAX reference: the feasibility and simulator models.

``pool/feasibility.py`` and ``pool/simulator.py`` compute on the host with
the same Python and numpy arithmetic as the reference, so every float is
held with ``==`` on the paper's engram-27b Engram config (E27), on its
engram-40b one (E40) where tests/test_pool.py runs both, and on the
tests' 3-layer deepseek-7b. ``replay_stall_s`` replays the port engine's recorded wave
trace, plain, sharded over a fabric, over a tier chain and speculative, to
the bit of the stall the engine accounted; the reference's replay of the
same trace gives the same number. ``replay_fleet_stall_s`` replays a
two-replica fleet's traces together, the port's and the reference's, to each
replica's stall. ``measured_scalability`` rides the port's ``serve``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.configs.base import ENGRAM_27B as REF_ENGRAM_27B  # noqa: E402
from repro.configs.base import ENGRAM_40B as REF_ENGRAM_40B  # noqa: E402
from repro.configs.base import EngramConfig as RefEngramConfig  # noqa: E402
from repro.configs.base import StoreConfig as RefStoreConfig  # noqa: E402
from repro.models.model import init_params as ref_init_params  # noqa: E402
from repro.pool import feasibility as ref_feas  # noqa: E402
from repro.pool import scheduler as ref_scheduler  # noqa: E402
from repro.pool import simulator as ref_sim  # noqa: E402
from repro.pool import tiers as ref_tiers  # noqa: E402
from repro.serving import Router as RefRouter  # noqa: E402
from repro_torch.configs import ENGRAM_27B, ENGRAM_40B  # noqa: E402
from repro_torch.configs import EngramConfig  # noqa: E402
from repro_torch.configs import SpecConfig, StoreConfig  # noqa: E402
from repro_torch.configs import deepseek_7b  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.pool import (TIERS, check, check_all_tiers,  # noqa: E402
                              latency_sweep, paper_case_study,
                              rdma_rescue_sweep, read_latency_s,
                              scalability_table, throughput_table)
from repro_torch.pool import feasibility as feas  # noqa: E402
from repro_torch.pool import scheduler as port_scheduler  # noqa: E402
from repro_torch.pool import simulator as sim  # noqa: E402
from repro_torch.serving import (Engine, EngramRuntime, Router,  # noqa: E402
                                 Workload)
from repro_torch.spec import ScriptedProposer  # noqa: E402

torch.set_num_threads(2)

E27 = EngramConfig(**ENGRAM_27B)
REF_E27 = RefEngramConfig(**REF_ENGRAM_27B)
E40 = EngramConfig(**ENGRAM_40B)
REF_E40 = RefEngramConfig(**REF_ENGRAM_40B)
CHAIN = dict(cache_rows=32, warm_rows=256, aging_half_life_s=0.05)


def _asdicts(rows):
    return [dataclasses.asdict(r) if dataclasses.is_dataclass(r) else r
            for r in rows]


# ------------------------------------------- Table 1 (tests/test_pool.py)


def test_case_study_matches_reference():
    """Table 1: the bandwidth bound (about 0.7 GB/s at 70k tokens/s), the
    prefetch window of layer 2 (about 56 us) and the verdicts per tier
    (DRAM and CXL fit, RDMA does not), each equal to the reference's."""
    point = paper_case_study()
    assert dataclasses.asdict(point) == \
        dataclasses.asdict(ref_feas.paper_case_study())
    f = check(E27, point, TIERS["CXL"])
    assert 0.6e9 < f.bandwidth_required_Bps < 0.8e9 and f.bandwidth_ok
    f2 = check(E27, point, TIERS["CXL"], engram_layer_k=2)
    assert 50e-6 < f2.prefetch_window_s < 62e-6
    assert dataclasses.asdict(f2) == dataclasses.asdict(ref_feas.check(
        REF_E27, ref_feas.paper_case_study(), ref_tiers.TIERS["CXL"],
        engram_layer_k=2))
    res = check_all_tiers(E27, point)
    want = ref_feas.check_all_tiers(REF_E27, ref_feas.paper_case_study())
    assert {k: dataclasses.asdict(v) for k, v in res.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert res["DRAM"].ok and res["CXL"].ok and not res["RDMA"].ok
    for k in (1, 2, 3, 40):
        assert feas.prefetch_window_s(point, k) == \
            ref_feas.prefetch_window_s(ref_feas.paper_case_study(), k)
    for qps in (1e3, 7e4):
        assert feas.required_bandwidth_Bps(E27, qps) == \
            ref_feas.required_bandwidth_Bps(REF_E27, qps)


# ------------------------------------------------------ Figs 3/5/6


def test_latency_sweep_matches_reference():
    """Figs 3/5/6 on E27: DRAM <= CXL < RDMA at every batch, CXL near
    DRAM, RDMA far off; the sweep equals the reference's."""
    sweep = latency_sweep(E27, batch_sizes=(1, 64, 256, 1024))
    assert sweep == ref_sim.latency_sweep(REF_E27,
                                          batch_sizes=(1, 64, 256, 1024))
    for i, (b, _) in enumerate(sweep["DRAM"]):
        dram, cxl, rdma = (sweep[t][i][1] for t in ("DRAM", "CXL", "RDMA"))
        assert dram <= cxl < rdma, (b, dram, cxl, rdma)
        assert cxl < 10 * dram and rdma > 5 * cxl


@pytest.mark.parametrize("name", ["E27", "E40"])
def test_latency_ordering_dram_cxl_rdma(name):
    """Twin of tests/test_pool.py's, on both paper configs: DRAM <= CXL <
    RDMA, CXL within 10x of DRAM, RDMA beyond 5x CXL; the sweep equals the
    reference's."""
    ecfg, ref_ecfg = {"E27": (E27, REF_E27), "E40": (E40, REF_E40)}[name]
    sweep = latency_sweep(ecfg, batch_sizes=(1, 64, 256, 1024))
    assert sweep == ref_sim.latency_sweep(ref_ecfg,
                                          batch_sizes=(1, 64, 256, 1024))
    for i, (b, _) in enumerate(sweep["DRAM"]):
        dram, cxl, rdma = (sweep[t][i][1] for t in ("DRAM", "CXL", "RDMA"))
        assert dram <= cxl < rdma, (b, dram, cxl, rdma)
        assert cxl < 10 * dram and rdma > 5 * cxl


def test_latency_scale_invariant_in_table_size():
    """Paper §5.2: CXL read efficiency does not diminish as Engram scales
    (27B vs 40B tables give the same latency; only the vocabulary grows),
    and each equals the reference's."""
    for b in (16, 256):
        l27 = read_latency_s(E27, TIERS["CXL"], b)
        l40 = read_latency_s(E40, TIERS["CXL"], b)
        assert abs(l27 - l40) / l27 < 1e-9
        assert l40 == ref_sim.read_latency_s(REF_E40, ref_tiers.TIERS["CXL"],
                                             b)


@pytest.mark.parametrize("b", [1, 17, 256, 1000, 4096])
def test_read_latency_monotone_and_equal(b):
    for t in ("DRAM", "CXL", "RDMA"):
        lat = read_latency_s(E27, TIERS[t], b)
        assert lat <= read_latency_s(E27, TIERS[t], b + 64)
        assert lat == ref_sim.read_latency_s(REF_E27, ref_tiers.TIERS[t], b)
    assert read_latency_s(E27, TIERS["CXL"], b, gpu_path=True) == \
        ref_sim.read_latency_s(REF_E27, ref_tiers.TIERS["CXL"], b,
                               gpu_path=True)


# ------------------------------------------------------- Tables 2/3


def test_throughput_table_matches_reference():
    """Table 2: baseline >= +Engram(DRAM) >= +Engram(CXL) >> +Engram(RDMA),
    through the port's scheduler, store and clock."""
    rows = throughput_table(E27, paper_case_study())
    assert _asdicts(rows) == _asdicts(ref_sim.throughput_table(
        REF_E27, ref_feas.paper_case_study()))
    tps = {r.config: r.tokens_per_s for r in rows}
    assert tps["baseline"] > tps["+Engram (DRAM)"] >= tps["+Engram (CXL)"]
    assert tps["+Engram (CXL)"] > 0.9 * tps["+Engram (DRAM)"]
    assert tps["+Engram (RDMA)"] < 0.9 * tps["+Engram (CXL)"]


@pytest.mark.parametrize("pool_nodes", [None, 1, 4])
def test_scalability_table_matches_reference(pool_nodes):
    """Table 3: DP = 2 scales about 1.46x, nnode = 2 costs 1 to 1.5 %."""
    rows = scalability_table(E27, paper_case_study(), pool_nodes=pool_nodes)
    assert rows == ref_sim.scalability_table(
        REF_E27, ref_feas.paper_case_study(), pool_nodes=pool_nodes)
    if pool_nodes is None:
        by = {(r["dp"], r["nnode"]): r["tokens_per_s"] for r in rows}
        assert 1.3 * by[(1, 1)] < by[(2, 1)] < 1.6 * by[(1, 1)]
        assert 0.97 * by[(1, 1)] < by[(1, 2)] < by[(1, 1)]
        assert 0.97 * by[(2, 1)] < by[(2, 2)] < by[(2, 1)]


# ----------------------------- §6 rescue (tests/test_rdma_rescue.py)


def test_rdma_rescue_matches_reference():
    """Plain RDMA never fits the window; aggregated RDMA fits at a 0.99
    hit rate, not without a cache; the sweep equals the reference's."""
    rows = rdma_rescue_sweep(E27, paper_case_study())
    assert rows == ref_sim.rdma_rescue_sweep(REF_E27,
                                             ref_feas.paper_case_study())
    assert not any(r["fits"] for r in rows)
    by = {r["hit_rate"]: r for r in rows}
    assert not by[0.0]["fits_agg"] and by[0.99]["fits_agg"]


def test_cached_latency_monotone_in_hit_rate():
    prev = None
    for h in (0.0, 0.3, 0.6, 0.9, 0.99):
        lat = sim.cached_read_latency_s(E27, TIERS["RDMA"], 256, h)
        assert lat == ref_sim.cached_read_latency_s(
            REF_E27, ref_tiers.RDMA, 256, h)
        if prev is not None:
            assert lat <= prev + 1e-12
        prev = lat


def test_engram_step_overhead_matches_reference():
    point = paper_case_study()
    for t in ("DRAM", "CXL", "RDMA", "RDMA-agg", "SSD"):
        assert sim.engram_step_overhead_s(E27, point, TIERS[t], 1e-4) == \
            ref_sim.engram_step_overhead_s(
                REF_E27, ref_feas.paper_case_study(), ref_tiers.TIERS[t],
                1e-4)


# -------------------------- placement solver (tests/test_tiering.py)


@pytest.fixture(scope="module")
def tiny():
    cfg = deepseek_7b.reduced()
    cfg = dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                              attn_kinds=("global",) * 3,
                              ffn_types=("dense",) * 3,
                              engram=dataclasses.replace(cfg.engram,
                                                         layers=(1,)))
    rcfg = ref_deepseek_7b.reduced()
    rcfg = dataclasses.replace(rcfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3,
                               engram=dataclasses.replace(rcfg.engram,
                                                          layers=(1,)))
    rparams = ref_init_params(rcfg, 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, rcfg, params, rparams


def test_hit_fractions_match_reference():
    for args in ((64, 192, 4096, 1.0), (0, 0, 100, 1.0), (100, 0, 100, 1.0),
                 (16, 1024, 4096, 0.8), (5000, 10, 4096, 1.2)):
        got = sim.chain_hit_fractions(*args)
        assert got == ref_sim.chain_hit_fractions(*args)
        assert sum(got) == pytest.approx(1.0)
    pf, pw, pc = sim.chain_hit_fractions(64, 192, 4096, 1.0)
    assert pf > 0 and pw > 0 and pc > 0 and pf > pw * 64 / 192


def test_solver_matches_brute_force_and_reference(tiny):
    cfg, rcfg, _, _ = tiny
    grid = dict(total_rows=4096, alpha=1.0, batch_tokens=64, step_s=2e-4,
                front_grid=(0, 16, 64, 256, 1024),
                warm_grid=(256, 1024, 2048, 4096),
                layers=cfg.engram_layers(), n_layers=cfg.n_layers,
                ttft_steps=2)
    for tgt in (4.08e-4, 4.8e-4, 6e-4, 1e-3):
        solver = sim.plan_placement(cfg.engram, ttft_target_s=tgt, **grid)
        sweep = sim.placement_sweep(cfg.engram, ttft_target_s=tgt, **grid)
        brute = sim._best_plan(sweep)
        assert solver.split == brute.split
        assert solver.feasible == brute.feasible
        assert solver.cost_usd == pytest.approx(brute.cost_usd)
        assert dataclasses.asdict(solver) == dataclasses.asdict(
            ref_sim.plan_placement(rcfg.engram, ttft_target_s=tgt, **grid))
        assert _asdicts(sweep) == _asdicts(ref_sim.placement_sweep(
            rcfg.engram, ttft_target_s=tgt, **grid))
    lax = sim.plan_placement(cfg.engram, ttft_target_s=1e-3, **grid)
    tight = sim.plan_placement(cfg.engram, ttft_target_s=4.08e-4, **grid)
    assert lax.cold_rows >= tight.cold_rows and lax.cost_usd <= \
        tight.cost_usd


# --------------------------------------- replay (tests/test_clock.py)


def _ref_trace(trace):
    """The port's recorded waves as the reference's trace records."""
    out = []
    for w in trace:
        cls = ref_scheduler.SpecTraceWave \
            if isinstance(w, port_scheduler.SpecTraceWave) \
            else ref_scheduler.TraceWave
        out.append(cls(*(getattr(w, f.name) for f in dataclasses.fields(w))))
    return out


def _replays(ecfg, recfg, pool, trace, layers, n_layers, *,
             store_cfg=None, ref_store_cfg=None, fabric_nodes=None):
    """(the port's replay, the reference's replay) of one port trace."""
    got = sim.replay_stall_s(ecfg, pool, trace, layers=layers,
                             n_layers=n_layers, store_cfg=store_cfg,
                             fabric_nodes=fabric_nodes)
    want = ref_sim.replay_stall_s(recfg, pool, _ref_trace(trace),
                                  layers=layers, n_layers=n_layers,
                                  store_cfg=ref_store_cfg,
                                  fabric_nodes=fabric_nodes)
    return got, want


@pytest.mark.parametrize("pool,fabric_nodes", [("CXL", None), ("RDMA", None),
                                               ("CXL", 2), ("RDMA", 2)])
def test_engine_stall_matches_simulator_replay(tiny, pool, fabric_nodes):
    """The one-clock regression: the port engine's accounted stall and the
    simulator's replay of its trace agree bit for bit, for a hidden tier
    (CXL) and an overshooting one (RDMA), on one link and over a 2-node
    fabric (recorded per-shard splits); the reference's replay of the same
    trace gives the same stall."""
    cfg, rcfg, params, _ = tiny
    kw = {"fabric_nodes": fabric_nodes} if fabric_nodes else {}
    eng = Engine(cfg, params=params, max_batch=2, max_len=32,
                 prompt_bucket=8, pool=pool, emulate_step_s=5e-5,
                 device="cpu", **kw)
    for r in range(4):
        eng.submit([5 + r, 17, 42], max_new=4)
    stats = eng.run()
    assert (stats.stall_s > 0) == (pool == "RDMA")
    assert stats.v_time_s > 0
    if fabric_nodes:
        assert any(len(e) > 2 for wv in eng.scheduler.trace
                   for e in wv.split)
    got, want = _replays(cfg.engram, rcfg.engram, pool, eng.scheduler.trace,
                         cfg.engram_layers(), cfg.n_layers,
                         fabric_nodes=fabric_nodes)
    assert got == stats.stall_s == want


@pytest.mark.parametrize("pipeline", [False, True])
def test_spec_wave_trace_replays_bit_identical(tiny, pipeline):
    """Speculative waves are trace-recorded (per-position splits, verified
    n_keep, early-issue credit) and replay through speculative_wave and
    charge_spec to the identical stall total."""
    cfg, rcfg, params, _ = tiny
    prompts = [[5, 17, 42], [7, 8, 9, 10]]
    kw = dict(max_batch=2, max_len=64, prompt_bucket=8, pool="RDMA",
              emulate_step_s=5e-5, device="cpu")
    plain = Engine(cfg, params=params, **kw)
    rids = [plain.submit(list(p), max_new=8) for p in prompts]
    plain.run()
    streams = [p + plain.done[r].out for p, r in zip(prompts, rids)]
    eng = Engine(cfg, params=params,
                 spec=SpecConfig(max_draft=3, pipeline=pipeline),
                 proposer=ScriptedProposer(streams), **kw)
    for p in prompts:
        eng.submit(list(p), max_new=8)
    stats = eng.run()
    assert stats.stall_s > 0
    assert any(isinstance(wv, port_scheduler.SpecTraceWave)
               for wv in eng.scheduler.trace)
    got, want = _replays(cfg.engram, rcfg.engram, "RDMA",
                         eng.scheduler.trace, cfg.engram_layers(),
                         cfg.n_layers)
    assert got == stats.stall_s == want


@pytest.mark.parametrize("nodes", [None, 2])
def test_chain_trace_replay_bit_identical(tiny, nodes):
    """Tier-chain traces, plain and with the warm level sharded over a
    fabric, replay to the exact engine stall."""
    cfg, rcfg, params, _ = tiny
    scfg = StoreConfig(**CHAIN)
    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=scfg))
    kw = {"fabric_nodes": nodes} if nodes else {}
    rt = EngramRuntime(ccfg, params=params, max_batch=2, max_len=32,
                       prompt_bucket=8, pool="CXL+SSD", emulate_step_s=5e-5,
                       device="cpu", **kw)
    for r in range(4):
        rt.submit([5 + r, 17, 42], max_new=4)
    stats = rt.drain()
    eng = rt.engine
    assert eng.store.stats().cold_misses > 0
    got, want = _replays(ccfg.engram, rcfg.engram, "CXL+SSD",
                         eng.scheduler.trace, cfg.engram_layers(),
                         cfg.n_layers, store_cfg=scfg,
                         ref_store_cfg=RefStoreConfig(**CHAIN),
                         fabric_nodes=nodes)
    assert got == stats.stall_s == want


def _charge_order(monkeypatch, mod) -> list:
    """Record the scheduler of each plain wave, in the order charged."""
    order, step = [], mod.PrefetchScheduler.step

    def charged(self, *args, **kw):
        order.append(self)
        return step(self, *args, **kw)
    monkeypatch.setattr(mod.PrefetchScheduler, "step", charged)
    return order


@pytest.mark.parametrize("shared", [True, False])
def test_fleet_trace_replay_bit_identical(tiny, monkeypatch, shared):
    """A two-replica ``Router`` at the emulated point, its hot-row cache
    shared or private: the replicas' traces replayed together in charge
    order give each replica its accounted stall to the bit, which a lone
    replay of each trace misses (the other replica's waits on the shared
    links); the reference fleet's traces replay through the port's fleet
    replay to the reference's stalls, which equal the port's."""
    cfg, rcfg, params, rparams = tiny
    scfg = dict(cache_rows=64)
    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(**scfg)))
    rccfg = dataclasses.replace(rcfg, engram=dataclasses.replace(
        rcfg.engram, store=RefStoreConfig(**scfg)))
    kw = dict(replicas=2, pool="RDMA", shared_cache=shared, max_batch=2,
              max_len=32, prompt_bucket=8, emulate_step_s=5e-5)
    layers = dict(layers=cfg.engram_layers(), n_layers=cfg.n_layers)
    seen = []
    for make, c, p, mod, extra in (
            (Router, ccfg, params, port_scheduler, {"device": "cpu"}),
            (RefRouter, rccfg, rparams, ref_scheduler, {})):
        order = _charge_order(monkeypatch, mod)
        router = make(c, params=p, **kw, **extra)
        for r in range(6):
            router.submit([5 + r, 17, 42], max_new=4)
        router.drain()
        monkeypatch.undo()
        engines = [rt.engine for rt in router.replicas]
        scheds = [e.scheduler for e in engines]
        who = [next(i for i, s in enumerate(scheds) if s is o)
               for o in order]
        traces = [[port_scheduler.TraceWave(
            *(getattr(w, f.name) for f in dataclasses.fields(w)))
            for w in s.trace] for s in scheds]
        want = [e.stats.stall_s for e in engines]
        got = sim.replay_fleet_stall_s(ccfg.engram, "RDMA", traces, who,
                                       shared_cache=shared, **layers)
        assert got == want
        lone = [sim.replay_stall_s(ccfg.engram, "RDMA", t, **layers)
                for t in traces]
        assert lone != want
        seen.append(want)
    assert seen[0] == seen[1]


# -------------------- measured Table 3 (tests/test_router.py twin)


def test_measured_scalability_rides_serve(tiny):
    """One row per DP degree from the port's ``serve``: every token served,
    the shared hot-row cache hit; the merged wall time is the slowest
    replica's (the parallel-hardware model, not the card's serial time)."""
    cfg, _, params, _ = tiny
    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=50_000)))
    rows = sim.measured_scalability(
        ccfg, Workload(requests=4, max_new=3, prompt_pool=2), dps=(1, 2),
        pool="RDMA", params=params, device="cpu", max_batch=2, max_len=64,
        prompt_bucket=8)
    assert [r["dp"] for r in rows] == [1, 2]
    assert all(r["tokens"] == 12 for r in rows)
    assert all(r["cache_hit_rate"] > 0.0 for r in rows)
    assert all(r["tokens_per_s"] == pytest.approx(r["tokens"] / r["wall_s"])
               for r in rows)
