"""PyTorch port vs the JAX reference: the fleet layer on the CPU.

The router (``Router``, ``RouterStats``, the dispatch policies and
re-dispatch), the shared caches (``SharedCache``, ``PrefixKVCache.view``),
``Workload`` and ``serve``. On tests/test_router.py's 3-layer deepseek-7b
(Engram at layer 1, a 50,000-row hot-row cache), with weights bridged from
the reference, the port's fleet must emit the reference fleet's token
streams and rids and leave equal ``RouterStats``, ``SharedCacheStats`` and
per-replica ``StoreStats``, field by field. In real mode (no emulated
operating point) the host-timed fields differ by nature (wall time, the
virtual clock that mirrors it, the window stall it prices); at the emulated
point every field and the clock agree to the bit. Inputs come from fixed
prompts and numpy seeds. Each reference fleet drive costs seconds of JIT,
so the reference runs are shared through a module fixture."""
import dataclasses
import zlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.configs.base import SpecConfig as RefSpecConfig  # noqa: E402
from repro.configs.base import StoreConfig as RefStoreConfig  # noqa: E402
from repro.models.model import init_params as ref_init_params  # noqa: E402
from repro.pool import cache as ref_cache  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import Router as RefRouter  # noqa: E402
from repro.serving import serve as ref_serve  # noqa: E402
from repro.serving import slo as ref_slo  # noqa: E402
from repro.serving import workload as ref_workload  # noqa: E402
from repro_torch.configs import SpecConfig, StoreConfig  # noqa: E402
from repro_torch.configs import deepseek_7b  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.pool import cache as port_cache  # noqa: E402
from repro_torch.serving import (POLICIES, EngineStats, OverloadPolicy,  # noqa: E402
                                 Request, Router, SLOSpec, Workload, serve)
from repro_torch.serving import workload as port_workload  # noqa: E402

torch.set_num_threads(2)

# fields the host's clock sets: wall time, and in real mode the virtual
# clock that mirrors it and the window stall it prices; the pad rows of
# the reference's power-of-two admission groups differ by design
HOST_TIMED = {"wall_s", "ttft_s_sum", "prefill_pad_tokens", "emu_time_s",
              "v_time_s", "ttft_v_sum", "stall_s"}
EMULATED_UNSHARED = {"wall_s", "ttft_s_sum", "prefill_pad_tokens"}
STORE_HOST_TIMED = {"stall_s", "hidden_waves", "wait_s"}
KW = dict(max_batch=2, max_len=64, prompt_bucket=8)
SHARED_WL = dict(requests=8, max_new=4, prompt_pool=2)
PROMPTS = [[3, 17, 42, 9], [5, 11, 7], [2, 8, 20, 13, 4], [6, 9]]


def _tiny(mod, scfg):
    """tests/test_router.py's config: 3 layers, Engram at layer 1."""
    cfg = mod.reduced()
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3,
                               engram=dataclasses.replace(
                                   cfg.engram, layers=(1,), store=scfg))


@pytest.fixture(scope="module")
def fleet():
    cfg = _tiny(deepseek_7b, StoreConfig(cache_rows=50_000))
    rcfg = _tiny(ref_deepseek_7b, RefStoreConfig(cache_rows=50_000))
    rparams = ref_init_params(rcfg, 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, rcfg, params, rparams


@pytest.fixture(scope="module")
def ref_runs(fleet):
    """Reference drives, each run once for the module."""
    _, rcfg, _, rparams = fleet
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


def _drive(router, cfg, specs):
    handles = [router.submit(list(s.prompt), s.max_new) for s in specs]
    router.drain()
    return handles


def _ref_drive(wl_kw, **kw):
    def run(rcfg, rparams):
        router = _router(RefRouter, rcfg, rparams, False, **kw)
        specs = ref_workload.Workload(**wl_kw).build(rcfg.vocab_size)
        return router, _drive(router, rcfg, specs)
    return run


def _port_drive(fleet, wl_kw, **kw):
    cfg, _, params, _ = fleet
    router = _router(Router, cfg, params, True, **kw)
    return router, _drive(router, cfg, Workload(**wl_kw).build(
        cfg.vocab_size))


def _stats_equal(a, b, skip):
    for f in dataclasses.fields(EngineStats):
        if f.name not in skip:
            assert getattr(a, f.name) == getattr(b, f.name), f.name


def _store_dicts(router, skip=frozenset()):
    return {name: {k: v for k, v in dataclasses.asdict(st).items()
                   if k not in skip}
            for name, st in router.store_stats().items()}


def _fleet_equal(port, ref, hp, hr, *, emulated=False):
    """Streams, rids, RouterStats (aggregate and per replica), the shared
    cache and each replica's StoreStats, field by field."""
    assert [h.tokens for h in hp] == [h.tokens for h in hr]
    assert [h.rid for h in hp] == [h.rid for h in hr]
    ps, rs = port.stats(), ref.stats()
    skip = EMULATED_UNSHARED if emulated else HOST_TIMED
    _stats_equal(ps.aggregate, rs.aggregate, skip)
    assert list(ps.per_replica) == list(rs.per_replica)
    for name in ps.per_replica:
        _stats_equal(ps.per_replica[name], rs.per_replica[name], skip)
    assert (ps.cache is None) == (rs.cache is None)
    if ps.cache is not None:
        assert dataclasses.asdict(ps.cache) == dataclasses.asdict(rs.cache)
    assert (ps.migrations, ps.shed, ps.deferred, ps.shed_by_class) == \
        (rs.migrations, rs.shed, rs.deferred, rs.shed_by_class)
    sskip = frozenset() if emulated else STORE_HOST_TIMED
    assert _store_dicts(port, sskip) == _store_dicts(ref, sskip)
    if emulated:
        assert ps.clock == rs.clock
        assert ps.fabric == rs.fabric


# ------------------------------------------------- tests/test_router.py


def test_shared_cache_beats_private_baseline(fleet, ref_runs):
    """Two replicas on one shared hot-row cache: the reference fleet's
    streams and every counter, and an aggregate hit rate strictly above two
    private caches' on the same workload."""
    cfg = fleet[0]
    ref, hr = ref_runs("shared_rr", _ref_drive(SHARED_WL,
                                               shared_cache=True))
    shared, hp = _port_drive(fleet, SHARED_WL, shared_cache=True)
    _fleet_equal(shared, ref, hp, hr)
    rs = shared.stats()
    assert all(v["hits"] + v["misses"] > 0
               for v in rs.cache.per_view.values())
    assert len(rs.cache.per_view) == 2

    private, hq = _port_drive(fleet, SHARED_WL, shared_cache=False)
    assert private.shared_cache is None and private.stats().cache is None
    assert [h.tokens for h in hq] == [h.tokens for h in hr]
    stores = private.store_stats()
    assert len(stores) == 2
    hits = sum(s.hits for s in stores.values())
    total = sum(s.hits + s.misses for s in stores.values())
    assert rs.cache.hit_rate > hits / total
    assert cfg.engram.store.cache_rows == 50_000


def test_shared_cache_matches_store_accounting(fleet, ref_runs):
    """Per-replica CachedStore hit/miss totals sum to the shared cache's
    aggregate (one accounting, two mounts), as in the reference."""
    router, _ = _port_drive(fleet, SHARED_WL, shared_cache=True)
    agg = router.stats().cache
    stores = router.store_stats()
    assert sum(s.hits for s in stores.values()) == agg.hits
    assert sum(s.misses for s in stores.values()) == agg.misses
    ref, _ = ref_runs("shared_rr", _ref_drive(SHARED_WL, shared_cache=True))
    assert (agg.hits, agg.misses) == (ref.stats().cache.hits,
                                      ref.stats().cache.misses)
    # both views mount the one cache and share its rows
    v0, v1 = (rt.store.cache for rt in router.replicas)
    assert v0.shared is v1.shared is router.shared_cache
    assert len(v0) == len(v1) == agg.rows > 0


def test_round_robin_and_least_loaded_balance(fleet, ref_runs):
    rr, handles = _port_drive(fleet, SHARED_WL, policy="round_robin")
    per = rr.stats().per_replica
    assert [st.prefills for st in per.values()] == [4, 4]
    assert all(h.finished for h in handles)

    ll, hp = _port_drive(fleet, SHARED_WL, policy="least_loaded")
    prefills = [st.prefills for st in ll.stats().per_replica.values()]
    assert sum(prefills) == 8 and max(prefills) - min(prefills) <= 1
    ref, hr = ref_runs("ll", _ref_drive(SHARED_WL, policy="least_loaded"))
    _fleet_equal(ll, ref, hp, hr)


def test_cache_affinity_pins_repeat_prompts(fleet, ref_runs):
    """Identical prompts always land on the same replica, the replica the
    reference's affinity hash picks (the port hashes on the host)."""
    cfg = fleet[0]
    router = _router(Router, cfg, fleet[2], True, policy="cache_affinity")
    ref, _ = ref_runs("shared_rr", _ref_drive(SHARED_WL, shared_cache=True))
    specs = Workload(requests=6, max_new=2, prompt_pool=2).build(
        cfg.vocab_size)
    chosen = {}
    for s in specs:
        idx = router.select_replica(list(s.prompt))
        assert chosen.setdefault(s.prompt, idx) == idx
    # one prompt length: the reference hashes through one JIT shape
    prompts = np.random.RandomState(5).randint(
        1, cfg.vocab_size, size=(12, 6)).tolist()
    for p in prompts:
        assert router._affinity_hash(p) == ref._affinity_hash(p)
    assert {router.select_replica(p) for p in prompts} == {0, 1}


def test_aggregate_stats_sum_replicas(fleet, ref_runs):
    router, handles = _port_drive(fleet, SHARED_WL)
    rs = router.stats()
    assert rs.aggregate.generated_tokens == \
        sum(st.generated_tokens for st in rs.per_replica.values()) == 32
    assert rs.aggregate.requests_completed == len(handles) == 8
    # fleet wall clock models parallel replicas: the slowest one
    assert rs.aggregate.wall_s == \
        max(st.wall_s for st in rs.per_replica.values())
    assert len({h.rid for h in handles}) == len(handles)
    assert [h.rid for h in handles] == [1, 1_000_001, 2, 1_000_002, 3,
                                        1_000_003, 4, 1_000_004]
    ref, _ = ref_runs("shared_rr", _ref_drive(SHARED_WL, shared_cache=True))
    _stats_equal(rs.aggregate, ref.stats().aggregate, HOST_TIMED)


def test_fleet_speculation_metrics(fleet, ref_runs):
    """Per-replica proposed/accepted counters merge into the aggregate;
    RouterStats exposes the traffic-weighted acceptance rate; the fleet
    matches the reference's speculating fleet."""
    wl = dict(requests=12, max_new=6, prompt_pool=2)
    router, hp = _port_drive(fleet, wl, spec=SpecConfig(max_draft=2))
    ref, hr = ref_runs("spec", _ref_drive(wl,
                                          spec=RefSpecConfig(max_draft=2)))
    _fleet_equal(router, ref, hp, hr)
    rs = router.stats()
    per = rs.per_replica
    proposed = sum(st.proposed_tokens for st in per.values())
    accepted = sum(st.accepted_tokens for st in per.values())
    assert proposed > 0
    assert rs.aggregate.proposed_tokens == proposed
    assert rs.aggregate.accepted_tokens == accepted
    assert rs.acceptance_rate == pytest.approx(accepted / proposed)
    spec = rs.speculation
    assert spec == ref.stats().speculation
    assert set(spec["per_replica"]) == set(per)
    for name, st in per.items():
        assert spec["per_replica"][name]["acceptance_rate"] == \
            pytest.approx(st.acceptance_rate)
    assert rs.acceptance_rate > 0.0


def test_serve_api_builds_router(fleet, ref_runs):
    cfg, _, params, _ = fleet
    res = serve(cfg, Workload(**SHARED_WL), pool="RDMA", replicas=2,
                params=params, device="cpu", **KW)
    assert res.stats.requests_completed == 8
    assert res.router.stats().cache is not None
    assert res.router.stats().cache_hit_rate > 0.0
    # the same fleet as the reference's router drive of the workload
    ref, hr = ref_runs("shared_rr", _ref_drive(SHARED_WL, shared_cache=True))
    _fleet_equal(res.router, ref, res.handles, hr)
    with pytest.raises(AssertionError, match="router run"):
        res.runtime


def test_redispatch_migrates_queued_requests(fleet, ref_runs):
    """Continuous re-dispatch on the shared clock: queued requests migrate
    off the backlogged replica, the same moves as the reference's, and
    every request completes through its new runtime."""
    lens = [12, 2, 12, 2, 12, 2]

    def drive(pkg_router, cfg, params, port):
        router = _router(pkg_router, cfg, params, port,
                         policy="least_loaded", max_batch=1)
        assert router.redispatch
        handles = [router.submit([5 + i, 17, 42], max_new=n)
                   for i, n in enumerate(lens)]
        router.drain()
        return router, handles

    router, hp = drive(Router, fleet[0], fleet[2], True)
    ref, hr = ref_runs("redispatch", lambda rcfg, rparams: drive(
        RefRouter, rcfg, rparams, False))
    _fleet_equal(router, ref, hp, hr)
    rs = router.stats()
    assert rs.migrations > 0 and router.migrations == rs.migrations
    assert all(h.finished for h in hp)
    assert [len(h.tokens) for h in hp] == lens
    assert rs.aggregate.requests_completed == len(hp)
    assert set(rs.clock["cursors"]) >= {"replica0", "replica1"}
    # a migrated handle follows its request to the replica that ran it
    for h in hp:
        assert h.rid in h.runtime.engine.done


def test_redispatch_off_for_affinity(fleet):
    cfg, _, params, _ = fleet
    router = _router(Router, cfg, params, True, policy="cache_affinity")
    assert not router.redispatch
    forced = _router(Router, cfg, params, True, policy="round_robin",
                     redispatch=True)
    assert forced.redispatch
    assert POLICIES == ("round_robin", "least_loaded", "cache_affinity")


def test_router_and_serve_default_to_the_card(fleet):
    """Without ``device`` the fleet runs on CUDA; with no card it raises
    instead of quietly running on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg, _, params, _ = fleet
    with pytest.raises(RuntimeError, match="CUDA"):
        Router(cfg, params=params, replicas=2, pool="CXL")
    with pytest.raises(RuntimeError, match="CUDA"):
        Router(cfg, replicas=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(cfg, Workload(requests=1, max_new=1), params=params)


def test_replicas_share_one_f32_head(fleet):
    """One f32 head for the fleet: every replica's engine holds the same
    ``w32`` tensor, made once from the shared bf16-or-f32 tree; with an
    f32 head (this config) that tensor is the head itself, not a copy."""
    cfg, _, params, _ = fleet
    router = _router(Router, cfg, params, True, replicas=3)
    heads = [rt.engine.params["head"] for rt in router.replicas]
    assert all(h["w32"] is heads[0]["w32"] for h in heads)
    assert heads[0]["w32"].data_ptr() == params["head"]["w"].data_ptr()
    bf16 = dict(params, head={"w": params["head"]["w"].bfloat16()})
    router = _router(Router, cfg, bf16, True)
    w32 = [rt.engine.params["head"]["w32"] for rt in router.replicas]
    assert w32[0] is w32[1] and w32[0].dtype == torch.float32
    assert "w32" not in bf16["head"]             # the caller's tree as given


# ------------------------------------- the other fleet cases of the suite


def test_router_rebalance_skips_non_queued(fleet):
    """tests/test_overload.py: re-dispatch moves only requests still
    "queued"; a preempted one stays on its origin replica. The same moves
    as the reference's router on the same queue."""
    cfg, rcfg, params, rparams = fleet
    moved = []
    for pkg_router, req_cls, c, p, port in (
            (Router, Request, cfg, params, True),
            (RefRouter, RefRequest, rcfg, rparams, False)):
        router = _router(pkg_router, c, p, port, pool="CXL",
                         policy="least_loaded", redispatch=False,
                         redispatch_skew=1, emulate_step_s=2e-4)
        donor = router.replicas[0].engine
        stuck = req_cls(900001, [1, 2, 3], 4)
        stuck.status = "preempted"
        donor.queue.append(stuck)
        donor.queue.extend(req_cls(900002 + i, [4, 5], 4) for i in range(3))
        n = router.rebalance()
        assert n > 0
        assert stuck in donor.queue
        dst = router.replicas[1].engine
        assert all(r.status == "queued" for r in dst.queue)
        moved.append((n, [r.rid for r in donor.queue],
                      [r.rid for r in dst.queue]))
    assert moved[0] == moved[1]


# -------------------------------------------------------------- caches


def test_shared_cache_views_match_reference():
    """Two views of one SharedCache over Zipf waves: the same per-view and
    aggregate hits, misses and evictions as the reference's, and rows one
    view fetched are hits for the other."""
    caches = [pkg.SharedCache(256, admission=pkg.TinyLFUAdmission())
              for pkg in (port_cache, ref_cache)]
    views = [[c.view("r0"), c.view("r1")] for c in caches]
    for i in range(10):
        keys = ref_cache.zipf_keys(200, 2048, alpha=1.1, seed=i)
        waves = [vs[i % 2].access_wave(keys) for vs in views]
        assert (waves[0].hits, waves[0].misses) == \
            (waves[1].hits, waves[1].misses)
        if i == 5:
            kv = np.arange(40, dtype=np.int64) | np.int64(1 << 62)
            assert views[0][0].occupy(kv) == views[1][0].occupy(kv)
    port, ref = caches
    assert dataclasses.asdict(port.stats()) == dataclasses.asdict(ref.stats())
    assert port.stats().per_view["r1"]["hits"] > 0
    with pytest.raises(AssertionError, match="duplicate"):
        port.view("r0")


@pytest.mark.parametrize("alpha,n,vocab,seed", [
    (1.2, 500, 4096, 0), (1.05, 64, 100, 3), (1.0, 300, 2048, 1),
    (0.8, 100, 50, 7)])
def test_zipf_keys_match_reference(alpha, n, vocab, seed):
    got = port_cache.zipf_keys(n, vocab, alpha=alpha, seed=seed)
    np.testing.assert_array_equal(
        got, ref_cache.zipf_keys(n, vocab, alpha=alpha, seed=seed))
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < vocab


# ------------------------------------------------------------ workload


WORKLOADS = [
    dict(requests=6, max_new=4),
    dict(requests=5, max_new=4, max_new_jitter=2, prompt_pool=2,
         arrival="paced", arrival_every=3, seed=7),
    dict(requests=32, arrival="poisson", qps=1000.0, zipf_alpha=1.2,
         zipf_fraction=0.5, seed=3),
    dict(requests=32, max_new=4, arrival="mmpp", qps=2000.0,
         burst_factor=8.0, calm_s=0.05, burst_s=0.02,
         interactive_fraction=0.25, seed=7),
    dict(requests=16, max_new=4, arrival="trace",
         trace=tuple(0.001 * i for i in range(16)), seed=7),
    dict(requests=6, prompts=((1, 2, 3), (4, 5)), max_new=3),
    dict(requests=8, prefix_pool=3, prefix_len=12, prefix_zipf_alpha=1.1,
         zipf_alpha=0.9, seed=2),
    dict(requests=6, max_new=3, arrival="paced", arrival_every=3,
         prefix_pool=1, prefix_len=24, seed=0),
]


@pytest.mark.parametrize("wl", WORKLOADS)
def test_workload_build_matches_reference(wl):
    """Every arrival kind and prompt option builds the reference's
    RequestSpec list, deterministically in the seed."""
    got = Workload(**wl).build(1000)
    want = ref_workload.Workload(**wl).build(1000)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert Workload(**wl).build(1000) == got


def test_mmpp_and_trace_arrivals_pinned_checksum():
    """tests/test_overload.py's pinned checksums hold for the port's
    copy, and the workload validates its arguments as the reference's."""
    w = Workload(requests=32, max_new=4, arrival="mmpp", qps=2000.0,
                 burst_factor=8.0, calm_s=0.05, burst_s=0.02,
                 interactive_fraction=0.25, seed=7)
    specs = w.build(64)
    arr = np.asarray([s.arrival_s for s in specs], np.float64)
    assert zlib.crc32(arr.tobytes()) == 0xCD2DD8F1
    assert np.all(np.diff(arr) >= 0.0)
    slos = "".join("i" if s.slo == "interactive" else "b" for s in specs)
    assert zlib.crc32(slos.encode()) == 0x5AE6F56E
    tr = tuple(0.001 * i for i in range(16))
    arr = np.asarray([s.arrival_s for s in Workload(
        requests=16, max_new=4, arrival="trace", trace=tr,
        seed=7).build(64)], np.float64)
    assert zlib.crc32(arr.tobytes()) == 0x50FE0A48
    with pytest.raises(AssertionError):
        Workload(requests=4, arrival="trace", trace=(0.2, 0.1, 0.3, 0.4))
    with pytest.raises(AssertionError):
        Workload(requests=8, arrival="trace", trace=(0.1, 0.2))
    with pytest.raises(AssertionError):
        Workload(requests=4, arrival="mmpp")
    assert port_workload._crc_seed(7, 2, 3) == ref_workload._crc_seed(7, 2, 3)


def test_poisson_workload_build():
    """tests/test_clock.py: poisson arrivals are positive, cumulative and
    deterministic; batch workloads keep step arrivals."""
    w = Workload(requests=32, arrival="poisson", qps=1000.0,
                 zipf_alpha=1.2, zipf_fraction=0.5, seed=3)
    specs = w.build(vocab_size=1000)
    times = [s.arrival_s for s in specs]
    assert all(t is not None and t > 0 for t in times)
    assert times == sorted(times)
    assert {s.klass for s in specs} == {"zipf", "uniform"}
    assert [s.arrival_s for s in w.build(1000)] == times
    b = Workload(requests=4, zipf_alpha=1.2).build(1000)
    assert all(s.arrival_s is None for s in b)
    assert all(s.klass == "zipf" for s in b)


def test_workload_build_deterministic_and_paced():
    """tests/test_runtime.py: paced arrivals, pooled prompts, jitter."""
    wl = Workload(requests=5, max_new=4, max_new_jitter=2, prompt_pool=2,
                  arrival="paced", arrival_every=3, seed=7)
    a, b = wl.build(256), wl.build(256)
    assert a == b
    assert [s.arrival_step for s in a] == [0, 3, 6, 9, 12]
    assert len({s.prompt for s in a}) <= 2
    assert sorted({s.max_new for s in a}) == [4, 5, 6]
