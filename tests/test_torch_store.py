"""PyTorch port vs the JAX reference: the hot-row cache and ``CachedStore``.

``LRUHotRowCache``, ``FrequencySketch``, ``TinyLFUAdmission`` and
``CachedStore`` (host-side numpy in both packages) are fed the same key
streams as the reference's and must count the same hits, misses,
evictions and latencies; the engine with a hot-row cache must emit the
reference's token streams with field-by-field equal ``StoreStats``, and
keep the paper's ordering end to end (tests/test_store.py: an RDMA pool
rescued by the cache, CXL near DRAM). Key streams come from the
reference's ``zipf_keys`` and numpy seeds."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.configs.base import ENGRAM_27B as REF_ENGRAM_27B  # noqa: E402
from repro.configs.base import EngramConfig as RefEngramConfig  # noqa: E402
from repro.configs.base import StoreConfig as RefStoreConfig  # noqa: E402
from repro.models.model import init_params as ref_init_params  # noqa: E402
from repro.pool import cache as ref_cache  # noqa: E402
from repro.pool import paper_case_study  # noqa: E402
from repro.pool import store as ref_store  # noqa: E402
from repro.pool.scheduler import (  # noqa: E402
    PrefetchScheduler as RefScheduler)
from repro.pool.simulator import cached_read_latency_s  # noqa: E402
from repro.pool.tiers import TIERS as REF_TIERS  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro_torch.configs import ENGRAM_27B, EngramConfig  # noqa: E402
from repro_torch.configs import StoreConfig, deepseek_7b  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.pool import cache as port_cache  # noqa: E402
from repro_torch.pool import store as port_store  # noqa: E402
from repro_torch.pool.scheduler import PrefetchScheduler  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

torch.set_num_threads(2)

E27 = EngramConfig(**ENGRAM_27B)
REF_E27 = RefEngramConfig(**REF_ENGRAM_27B)


def _admission(pkg, name):
    return None if name == "lru" else pkg.TinyLFUAdmission()


# ------------------------------------------------------------ cache parts

@pytest.mark.parametrize("admission", ["lru", "tinylfu"])
def test_lru_matches_reference_under_zipf(admission):
    """Wave by wave, the same hits and misses as the reference's LRU on a
    Zipf stream; a small cache still catches a large share."""
    stream = ref_cache.zipf_keys(60_000, 400_000, alpha=1.2, seed=0)
    port = port_cache.LRUHotRowCache(
        2_000, admission=_admission(port_cache, admission))
    ref = ref_cache.LRUHotRowCache(
        2_000, admission=_admission(ref_cache, admission))
    for i in range(0, stream.size, 1_024):
        a = port.access_wave(stream[i:i + 1_024])
        b = ref.access_wave(stream[i:i + 1_024])
        assert (a.hits, a.misses) == (b.hits, b.misses)
    assert (port.total_hits, port.total_misses, port.waves,
            port.evictions, len(port)) == \
        (ref.total_hits, ref.total_misses, ref.waves, ref.evictions,
         len(ref))
    assert port.hit_rate == ref.hit_rate > 0.4
    hot = int(np.bincount(stream).argmax())
    assert hot in port and hot in ref
    if admission == "tinylfu":
        assert port.admission.rejected == ref.admission.rejected > 0


def test_frequency_sketch_matches_reference():
    """Same estimates after the same observations, through the op-count
    halvings that age the sketch."""
    port = port_cache.FrequencySketch()
    ref = ref_cache.FrequencySketch()
    rng = np.random.RandomState(1)
    probe = np.arange(0, 200_000, 97)
    wave = 16_384
    saturated, halved = False, False
    for w in range(50):             # 819,200 observations: two halvings
        keys = rng.randint(0, 200_000, wave)
        keys[:16] = 7                # one hot key, saturated each wave
        port.observe(keys)
        ref.observe(keys)
        np.testing.assert_array_equal(port.estimate(probe),
                                      ref.estimate(probe))
        hot = int(port.estimate([7])[0])
        saturated |= hot == port.MAX_COUNT
        halved |= saturated and hot < port.MAX_COUNT
    assert halved
    assert port._ops == ref._ops < 50 * wave
    hot, cold = port.estimate([7, 123_456_789])
    assert hot >= cold >= 0


def test_tinylfu_resists_scans_like_reference():
    """A hot working set plus a never-repeating scan: plain LRU lets the
    scan flush the hot rows, TinyLFU keeps them; both rates are the
    reference's."""
    hot = np.arange(80)

    def drive(cache):
        scan, hot_hits, hot_total = 10_000, 0, 0
        for w in range(60):
            acc = cache.access_wave(hot)
            if w >= 10:
                hot_hits += acc.hits
                hot_total += acc.n_segments
            cache.access_wave(np.arange(scan, scan + 200))
            scan += 200
        return hot_hits / hot_total

    rates = {}
    for pkg in (port_cache, ref_cache):
        adm = pkg.TinyLFUAdmission()
        rates[pkg] = (drive(pkg.LRUHotRowCache(100)),
                      drive(pkg.LRUHotRowCache(100, admission=adm)),
                      adm.rejected)
    lru_rate, lfu_rate, rejected = rates[port_cache]
    assert rates[port_cache] == rates[ref_cache]
    assert lru_rate < 0.2 and lfu_rate > 0.9 and rejected > 0


# ------------------------------------------------------------ CachedStore

def _cached(pkg, e, tier="RDMA", rows=4 * 4096, admission="lru"):
    cache_pkg = port_cache if pkg is port_store else ref_cache
    return pkg.CachedStore(pkg.TierStore(e, tier), cache_tier="DRAM",
                           cache=cache_pkg.LRUHotRowCache(
                               rows, admission=_admission(cache_pkg,
                                                          admission)))


def test_cached_store_matches_reference_and_formula():
    """The measured hit/miss split through CachedStore gives the
    reference's latency, which is the analytic §6 formula at the same hit
    rate; ``ideal_latency_s`` is that formula."""
    b = 64
    n_seg = port_store.segment_count(E27, b)
    port, ref = _cached(port_store, E27), _cached(ref_store, REF_E27)
    half = n_seg // 2
    waves = [np.arange(n_seg),                            # cold: all miss
             np.concatenate([np.arange(half),             # half hits
                             np.arange(10 * n_seg, 10 * n_seg + half)]),
             np.arange(n_seg)]                            # all hits
    for wave, rate in zip(waves, (0.0, 0.5, 1.0)):
        a, r = port.prefetch(wave), ref.prefetch(wave)
        assert (a.n_segments, a.hits, a.misses, a.latency_s) == \
            (r.n_segments, r.hits, r.misses, r.latency_s)
        assert a.hits == int(rate * n_seg)
        assert a.latency_s == pytest.approx(cached_read_latency_s(
            REF_E27, REF_TIERS["RDMA"], b, rate), rel=1e-12)
    for rate in (0.0, 0.5, 0.9, 1.0):
        assert port.ideal_latency_s(b, rate) == ref.ideal_latency_s(b, rate)
        assert port.ideal_latency_s(b, rate) == pytest.approx(
            cached_read_latency_s(REF_E27, REF_TIERS["RDMA"], b, rate),
            rel=1e-12)
    assert dataclasses.asdict(port.stats()) == dataclasses.asdict(ref.stats())
    # in-wave duplicates ride one fetch: one miss, then one hit
    dup = _cached(port_store, E27, rows=100)
    assert (dup.prefetch(np.zeros(64, np.int64)).misses,
            dup.prefetch(np.zeros(64, np.int64)).hits) == (1, 1)


def test_make_store_builds_cached_store():
    scfg = StoreConfig(cache_rows=64, admission="tinylfu")
    store = port_store.make_store(E27, "RDMA", store_cfg=scfg)
    assert isinstance(store, port_store.CachedStore)
    assert isinstance(store.cache.admission, port_cache.TinyLFUAdmission)
    assert store.stats().cache_rows == 64
    assert store.stats().cache_tier == "DRAM"
    plain = port_store.make_store(E27, "RDMA",
                                  store_cfg=StoreConfig(cache_rows=64))
    assert plain.cache.admission is None               # LRU by default
    assert isinstance(port_store.make_store(E27, "CXL"),
                      port_store.TierStore)
    assert isinstance(port_store.make_store(E27, None, store_cfg=scfg),
                      port_store.LocalStore)
    with pytest.raises(ValueError):
        port_store.make_store(E27, "RDMA", store_cfg=StoreConfig(
            cache_rows=64, admission="bogus"))
    # a SharedCache (ported with the router) builds, and its views share
    # rows: a store over one view hits what the other view's store fetched
    shared = port_cache.SharedCache(64)
    stores = [port_store.make_store(E27, "RDMA", cache=shared.view(n))
              for n in ("r0", "r1")]
    assert all(st.cache.shared is shared for st in stores)
    assert stores[0].stats().cache_rows == 64
    keys = np.arange(16, dtype=np.int64)
    assert stores[0].prefetch(keys).misses == 16
    assert stores[1].prefetch(keys).hits == 16
    assert len(stores[1].cache) == len(shared.cache) == 16
    assert shared.stats().per_view["r1"]["hits"] == 16


def test_scheduler_cached_store_rescues_rdma():
    """§6 on the scheduler: a cold wave stalls on RDMA, the same rows again
    hide inside the window, with the reference's stall and hit rate."""
    point = paper_case_study()
    layers = [k - 1 for k in E27.layers]
    n_seg = port_store.segment_count(E27, point.batch_tokens)
    keys = [np.arange(n_seg) + j * 10 * n_seg for j in range(len(layers))]
    out = []
    for pkg, sched, e in ((port_store, PrefetchScheduler, E27),
                          (ref_store, RefScheduler, REF_E27)):
        store = _cached(pkg, e, rows=4 * n_seg)
        s = sched(store, e, layers, point.n_layers)
        cold = s.step(keys, point.step_latency_s)
        warm = s.step(keys, point.step_latency_s)
        out.append((cold.stall_s, warm.stall_s, warm.hidden,
                    store.stats().hit_rate))
    assert out[0] == out[1]
    cold_stall, warm_stall, hidden, hit_rate = out[0]
    assert cold_stall > 0.0 and warm_stall == 0.0 and hidden
    assert hit_rate == pytest.approx(0.5)


# ------------------------------------------------------------------ engine

def _tiny(mod, cache_rows=0, admission="lru"):
    cfg = mod.reduced()
    store_cls = StoreConfig if mod is deepseek_7b else RefStoreConfig
    e = dataclasses.replace(cfg.engram, layers=(1,),
                            store=store_cls(cache_rows=cache_rows,
                                            admission=admission))
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3, engram=e)


@pytest.fixture(scope="module")
def weights():
    rparams = ref_init_params(_tiny(ref_deepseek_7b), 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), _tiny(deepseek_7b),
                      device="cpu")
    return rparams, params


def _run(weights, pool, cache_rows=0, admission="lru", ref=False,
         requests=12):
    """tests/test_store.py's repeated-request run (the Zipf worst case, all
    hot) at the emulated operating point."""
    rparams, params = weights
    kw = dict(max_batch=1, max_len=32, prompt_bucket=8, pool=pool,
              emulate_step_s=5e-5)
    if ref:
        eng = RefEngine(_tiny(ref_deepseek_7b, cache_rows, admission),
                        params=rparams, **kw)
    else:
        eng = Engine(_tiny(deepseek_7b, cache_rows, admission),
                     params=params, device="cpu", **kw)
    for _ in range(requests):
        eng.submit([5, 17, 42], max_new=4)
    return eng, eng.run()


def _links(clock):
    """Clock link ledgers with the cache link's per-object name dropped."""
    return sorted((dict(st, name=n.split(":")[0]) for n, st in
                   clock.stats()["links"].items()), key=lambda d: d["name"])


@pytest.mark.parametrize("admission", ["lru", "tinylfu"])
def test_engine_with_hot_row_cache_matches_reference(weights, admission):
    """A clock-bound CachedStore in the engine: the reference's token
    streams, StoreStats, clock and both link ledgers (backing tier and the
    cache's own)."""
    eng, _ = _run(weights, "RDMA", 64, admission, requests=5)
    ref, _ = _run(weights, "RDMA", 64, admission, ref=True, requests=5)
    assert [r.out for r in eng.done.values()] == \
        [r.out for r in ref.done.values()]
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(ref.store.stats())
    assert eng.store.stats().hits > 0 and eng.store.stats().cache_rows == 64
    assert _links(eng.clock) == _links(ref.clock)
    assert eng.stats.emu_time_s == ref.stats.emu_time_s


def test_engine_rdma_rescue_end_to_end(weights):
    """§6 executed: with a hot-row cache at >= 0.9 measured hit rate an
    RDMA-backed run stalls less per wave than without it, by the
    reference's numbers."""
    plain = _run(weights, "RDMA")[0].store.stats()
    assert plain.stall_s > 0.0
    eng, _ = _run(weights, "RDMA", cache_rows=100_000)
    cached = eng.store.stats()
    assert cached.cache_rows == 100_000
    assert cached.hit_rate >= 0.9
    assert cached.stall_s_per_wave < plain.stall_s_per_wave
    assert cached.stall_s < plain.stall_s
    ref, _ = _run(weights, "RDMA", cache_rows=100_000, ref=True)
    assert dataclasses.asdict(cached) == dataclasses.asdict(ref.store.stats())


def test_engine_cxl_near_dram(weights):
    """The paper's Table 2 ordering through the store: DRAM and CXL hide
    every fetch, RDMA stalls, and CXL's emulated rate is within 5 % of
    DRAM's."""
    stats = {pool: _run(weights, pool, requests=3)[1]
             for pool in ("DRAM", "CXL", "RDMA")}
    assert stats["DRAM"].stall_s == 0.0
    assert stats["CXL"].stall_s == 0.0
    assert stats["RDMA"].stall_s > 0.0
    rate = {p: st.generated_tokens / st.emu_time_s
            for p, st in stats.items()}
    assert rate["CXL"] > 0.95 * rate["DRAM"]
