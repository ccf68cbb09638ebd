"""PyTorch port vs the JAX reference: overload serving on the CPU.

The KV side of the pool (``kv_page_keys``, ``KVPagePool``, ``PoolArbiter``,
``LRUHotRowCache.occupy``), the SLO table (``OverloadPolicy``) and the
engine's preemption, two-phase restore, idle spill and SLO admission.
On tests/test_overload.py's 3-layer deepseek-7b (Engram at layer 1), with
weights bridged from the reference, the port must emit the reference's
token streams, which are the never-preempted ones, and leave the same
``EngineStats`` (every field but the host-timed ones and the pad count of
the reference's power-of-two admission groups), ``KVPoolStats``,
``StoreStats``, hot-row cache and virtual clock, field by field. Inputs
come from fixed prompts and numpy seeds."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.configs.base import StoreConfig as RefStoreConfig  # noqa: E402
from repro.models.model import init_params as ref_init_params  # noqa: E402
from repro.pool import cache as ref_cache  # noqa: E402
from repro.pool import kvpool as ref_kvpool  # noqa: E402
from repro.serving import EngramRuntime as RefRuntime  # noqa: E402
from repro.serving import slo as ref_slo  # noqa: E402
from repro_torch.configs import SpecConfig, StoreConfig  # noqa: E402
from repro_torch.configs import deepseek_7b  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.pool import cache as port_cache  # noqa: E402
from repro_torch.pool import kvpool  # noqa: E402
from repro_torch.serving import EngineStats, EngramRuntime  # noqa: E402
from repro_torch.serving import slo  # noqa: E402

torch.set_num_threads(2)

PROMPTS = [[3, 17, 42, 9], [5, 11, 7], [2, 8, 20, 13, 4], [6, 9]]
# EngineStats fields the two engines need not share: host wall time, and
# the pad rows of the reference's power-of-two admission groups
UNSHARED = {"wall_s", "ttft_s_sum", "prefill_pad_tokens"}
STATS_FIELDS = [f.name for f in dataclasses.fields(EngineStats)
                if f.name not in UNSHARED]


def _tiny(mod, scfg=None):
    """tests/test_overload.py's config: 3 layers, Engram at layer 1."""
    cfg = mod.reduced()
    e = dataclasses.replace(cfg.engram, layers=(1,))
    if scfg is not None:
        e = dataclasses.replace(e, store=scfg)
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3, engram=e)


@pytest.fixture(scope="module")
def weights():
    rparams = ref_init_params(_tiny(ref_deepseek_7b), 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), _tiny(deepseek_7b),
                      device="cpu")
    return rparams, params


# ------------------------------------------------------------- KV pool

@pytest.mark.parametrize("n,page", [(0, 8), (3, 8), (8, 8), (19, 8),
                                    (40, 4), (97, 16)])
def test_kv_page_keys_match_reference(n, page):
    """Chained whole-page keys plus the tail key, bit-equal, over seeded
    streams (an empty stream, sub-page, whole pages, a partial page)."""
    toks = np.random.RandomState(n).randint(0, 1 << 20, size=n).tolist()
    got = kvpool.kv_page_keys(toks, page)
    assert got == ref_kvpool.kv_page_keys(toks, page)
    assert len(got) == max(1, -(-n // page))


def test_kv_pool_refusal_and_stats_match_reference():
    """The same spill/refuse/free sequence: the same page keys, refusals
    and stats; at capacity the pool refuses and never evicts."""
    ops = [("spill", 1, 600), ("spill", 2, 600), ("spill", 3, 300),
           ("free", 1, True), ("spill", 2, 600), ("free", 3, False),
           ("free", 9, False), ("spill", 4, 101), ("free", 2, True)]
    pools = (kvpool.KVPagePool(1000, page_tokens=4),
             ref_kvpool.KVPagePool(1000, page_tokens=4))
    for op, rid, arg in ops:
        toks = list(range(rid, rid + 5 + rid))
        if op == "spill":
            got = [p.spill(rid, toks, f"snap{rid}", len(toks), arg)
                   for p in pools]
        else:
            got = [p.free(rid, restored=arg) for p in pools]
        assert got[0] == got[1], (op, rid)
        assert [rid in p for p in pools] == [rid in pools[1]] * 2
    port, ref = pools
    assert dataclasses.asdict(port.stats()) == dataclasses.asdict(ref.stats())
    st = port.stats()
    assert st.refused == 1 and st.restores == 2 and st.peak_bytes == 900
    assert len(port) == 1 and port.fetch(4).nbytes == 101


def test_arbiter_cache_occupancy_matches_reference():
    for share in (0.0, 0.1, 0.25, 0.5, 1.0, 1.5, -0.2):
        a = kvpool.PoolArbiter(kv_cache_share=share)
        b = ref_kvpool.PoolArbiter(kv_cache_share=share)
        assert (a.paged_link, b.paged_link) == (True, True)
        for kv_rows, cap in ((1000, 100), (3, 100), (0, 64), (37, 7),
                             (2 ** 20, 2 ** 20)):
            assert a.cache_occupancy_rows(kv_rows, cap) == \
                b.cache_occupancy_rows(kv_rows, cap)
    assert kvpool.PoolArbiter(kv_cache_share=0.1).cache_occupancy_rows(
        1000, 100) == 10


@pytest.mark.parametrize("admission", ["lru", "tinylfu"])
def test_lru_occupy_matches_reference(admission):
    """``occupy`` inserts without counting hits or misses and counts its
    evictions; interleaved with Zipf waves, the same hits, misses,
    evictions and resident order as the reference's cache."""
    caches = [pkg.LRUHotRowCache(
        256, admission=None if admission == "lru" else pkg.TinyLFUAdmission())
        for pkg in (port_cache, ref_cache)]
    for i in range(12):
        keys = ref_cache.zipf_keys(200, 2048, alpha=1.1, seed=i)
        waves = [c.access_wave(keys) for c in caches]
        assert (waves[0].hits, waves[0].misses) == \
            (waves[1].hits, waves[1].misses)
        if i % 3 == 2:
            kv = (np.arange(40 + i, dtype=np.int64) + (i << 30)) \
                | np.int64(1 << 62)
            before = [(c.total_hits, c.total_misses) for c in caches]
            evicted = [c.occupy(kv) for c in caches]
            assert evicted[0] == evicted[1]
            assert [(c.total_hits, c.total_misses) for c in caches] == before
    port, ref = caches
    assert (port.evictions, port.total_hits, port.total_misses) == \
        (ref.evictions, ref.total_hits, ref.total_misses)
    assert list(port._rows) == list(ref._rows)
    assert port.evictions > 0


def test_overload_policy_matches_reference():
    """Priorities, deadlines, caps and over-cap behaviour per class,
    with the default table and a custom one with an unknown class."""
    @dataclasses.dataclass
    class Req:
        slo: str
        submitted_v: float

    for kw in ({}, dict(queue_cap=2, queue_cap_by_class={"batch": 5},
                        defer_classes=("batch", "bulk"),
                        default_ttft_s=0.5)):
        pol, rpol = slo.OverloadPolicy(**kw), ref_slo.OverloadPolicy(**kw)
        for name in ("interactive", "batch", "bulk", "nope"):
            assert dataclasses.astuple(pol.spec(name)) == \
                dataclasses.astuple(rpol.spec(name))
            assert pol.priority(name) == rpol.priority(name)
            assert pol.cap(name) == rpol.cap(name)
            assert pol.defers(name) == rpol.defers(name)
            r = Req(name, 0.125)
            assert pol.deadline_v(r) == rpol.deadline_v(r)
    assert slo.DEFAULT_SLOS.keys() == ref_slo.DEFAULT_SLOS.keys()
    for k, v in slo.DEFAULT_SLOS.items():
        assert dataclasses.astuple(v) == \
            dataclasses.astuple(ref_slo.DEFAULT_SLOS[k])
    pol = slo.OverloadPolicy()
    assert pol.priority("interactive") > pol.priority("batch")
    assert (pol.spill_pool_bytes, pol.spill_page_tokens, pol.preempt) == \
        (64 << 20, 8, True)


# ------------------------------------------------------------ the engine

def _fill_then_burst(rt):
    """Two long batch requests fill both slots; three steps later two
    interactive requests arrive (tests/test_overload.py's drive)."""
    hs = [rt.submit(PROMPTS[0], 20, slo="batch"),
          rt.submit(PROMPTS[1], 20, slo="batch")]
    for _ in range(3):
        rt.step()
    hs += [rt.submit(PROMPTS[2], 6, slo="interactive"),
           rt.submit(PROMPTS[3], 6, slo="interactive")]
    return hs


def _long_ctx(rt):
    """tests/test_tiering.py's idle-spill drive: 4 requests, 2 slots."""
    return [rt.submit(p, max_new=12) for p in PROMPTS]


def _policy(pkg, pool_bytes=8 << 20):
    return pkg.OverloadPolicy(spill_pool_bytes=pool_bytes,
                              spill_page_tokens=4)


# case -> (store config kwargs, engine kwargs per package, drive)
CASES = {
    "preempt": ({}, lambda p: dict(slo_policy=_policy(p.slo)),
                _fill_then_burst),
    "preempt_arbiter_cache": (
        dict(cache_rows=64, admission="tinylfu"),
        lambda p: dict(slo_policy=_policy(p.slo),
                       arbiter=p.kvpool.PoolArbiter(kv_cache_share=0.5)),
        _fill_then_burst),
    "backpressure": ({}, lambda p: dict(slo_policy=_policy(p.slo, 1024)),
                     _fill_then_burst),
    "idle_spill": ({}, lambda p: dict(idle_spill_tokens=4), _long_ctx),
    "chunked_slo": ({}, lambda p: dict(slo_policy=_policy(p.slo),
                                       prefill_chunk=4),
                    _fill_then_burst),
}


class _Port:
    slo, kvpool = slo, kvpool


class _Ref:
    slo, kvpool = ref_slo, ref_kvpool


def _runtime(ref: bool, weights, scfg=None, **kw):
    rparams, params = weights
    common = dict(pool="CXL", max_batch=2, max_len=64, prompt_bucket=8,
                  emulate_step_s=2e-4)
    common.update(kw)
    if ref:
        cfg = _tiny(ref_deepseek_7b,
                    RefStoreConfig(**scfg) if scfg else None)
        return RefRuntime(cfg, params=rparams, **common)
    cfg = _tiny(deepseek_7b, StoreConfig(**scfg) if scfg else None)
    return EngramRuntime(cfg, params=params, device="cpu", **common)


def _reads_per_step(rt):
    eng = rt.engine
    reads = []
    while eng.busy:
        before = eng.stats.d2h_pulls
        rt.step()
        reads.append(eng.stats.d2h_pulls - before)
    return reads


def _links(clock):
    """Clock ledgers with per-object link names (``cache:<id>``) cut."""
    st = clock.stats()
    links = sorted((dict(v, name=n.split(":")[0]) for n, v in
                    st["links"].items()), key=lambda d: d["name"])
    return dict(st, links=links)


@pytest.fixture(scope="module")
def engine_runs(weights):
    """Each case run once on both engines, and (port only) without the
    overload options: ``{case: (reference runtime, port runtime, reference
    handles, port handles, reference reads per step, port reads per step,
    control streams)}``, filled on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            scfg, kw, drive = CASES[case]
            out = []
            for ref, pkg in ((True, _Ref), (False, _Port)):
                rt = _runtime(ref, weights, scfg, **kw(pkg))
                hs = drive(rt)
                out.append((rt, hs, _reads_per_step(rt)))
            plain = _runtime(False, weights, scfg,
                             prefill_chunk=kw(_Port).get("prefill_chunk"))
            hs = drive(plain)
            plain.drain()
            (rrt, rhs, rreads), (prt, phs, preads) = out
            cache[case] = (rrt, prt, rhs, phs, rreads, preads,
                           [h.request.out for h in hs])
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_overload_engine_matches_reference(engine_runs, case):
    """Token streams equal to the reference's and to the run without the
    overload options; EngineStats, reads per step, KVPoolStats,
    StoreStats, the hot-row cache and the virtual clock equal to the
    reference's."""
    rrt, prt, rhs, phs, rreads, preads, plain = engine_runs(case)
    got = [h.request.out for h in phs]
    assert got == [h.request.out for h in rhs] == plain
    assert [h.request.preemptions for h in phs] == \
        [h.request.preemptions for h in rhs]
    assert [h.request.spill_mark for h in phs] == \
        [h.request.spill_mark for h in rhs]
    eng, ref = prt.engine, rrt.engine
    for f in STATS_FIELDS:
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    assert preads == rreads
    assert dataclasses.asdict(eng.kv_pool.stats()) == \
        dataclasses.asdict(ref.kv_pool.stats())
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(ref.store.stats())
    cache = getattr(eng.store, "cache", None)
    if cache is not None:
        rc = ref.store.cache
        assert (cache.evictions, cache.total_hits, cache.total_misses) == \
            (rc.evictions, rc.total_hits, rc.total_misses)
        assert list(cache._rows) == list(rc._rows)
    assert _links(eng.clock) == _links(ref.clock)
    assert [h.request.first_token_v for h in phs] == \
        [h.request.first_token_v for h in rhs]
    assert not eng.busy and not eng._spilled


def test_overload_cases_cover_what_they_claim(engine_runs):
    """Preemption spills and restores the same bytes, each counted once
    in the "kv" ledger; a full pool refuses every spill; idle spill parks
    and resumes without a policy; a hot-row cache under landed KV pages
    evicts and still hits, with one link booking per page; chunked
    admission preempts too."""
    eng = engine_runs("preempt")[1].engine
    st = eng.stats
    assert st.preemptions == st.resumes == 2
    assert st.kv_spill_bytes == st.kv_restore_bytes > 0
    assert eng.store.stats().class_bytes["kv"] == 2 * st.kv_spill_bytes
    assert eng.kv_pool.stats().restores == 2
    full = engine_runs("backpressure")[1].engine
    assert full.stats.preemptions == 0 and full.kv_pool.stats().refused > 0
    idle = engine_runs("idle_spill")[1].engine
    assert idle.slo_policy is None
    assert idle.stats.resumes == idle.stats.idle_spills > 0
    cached = engine_runs("preempt_arbiter_cache")[1].engine
    assert cached.store.cache.evictions > 0
    assert cached.store.stats().hits > 0
    links = [e.clock.stats()["links"]["tier:CXL"]["reservations"]
             for e in (cached, eng)]
    assert links[0] > links[1]
    chunked = engine_runs("chunked_slo")[1].engine
    assert chunked.stats.preemptions > 0 and chunked.stats.resumes > 0


def test_preempt_reads_one_snapshot_each(weights):
    """Reads per step around preemption: one per decode wave and per
    admission group, one per preemption (the snapshot), and one more for
    the keys of a decode wave after an admission or a restore; a step
    whose slots are all mid-restore reads nothing."""
    rt = _runtime(False, weights, slo_policy=_policy(slo))
    eng = rt.engine
    _fill_then_burst(rt)
    log = []
    while eng.busy:
        st = eng.stats
        before = (st.d2h_pulls, st.preemptions, st.resumes,
                  st.prefill_waves, st.decode_steps)
        rt.step()
        log.append([b - a for a, b in zip(before, (
            st.d2h_pulls, st.preemptions, st.resumes, st.prefill_waves,
            st.decode_steps))])
    for reads, pre, res, groups, dec in log:
        assert reads == dec + pre + groups + int(dec > 0 and
                                                 (groups > 0 or res > 0))
    assert sum(r[1] for r in log) == sum(r[2] for r in log) == 2
    assert [0, 0, 0, 0, 0] in log          # both slots mid-restore


@pytest.mark.parametrize("phase", ["spill", "restore"])
def test_cancel_mid_spill_or_restore_matches_reference(weights, phase):
    """Cancel a parked request mid-spill (its page bookings refunded
    newest-first, the whole spill unwound) or mid-restore (the fetch
    refunded and the claimed slot freed): the same clock, link ledgers
    and pool as the reference's, and the engine drains."""
    seen = []
    for ref, pkg in ((True, _Ref), (False, _Port)):
        rt = _runtime(ref, weights, slo_policy=_policy(pkg.slo),
                      arbiter=pkg.kvpool.PoolArbiter(paged_link=True))
        rt.submit(PROMPTS[0], 20, slo="batch")
        rt.submit(PROMPTS[1], 20, slo="batch")
        for _ in range(3):
            rt.step()
        eng = rt.engine
        link = eng._pool_link()
        kv0 = link.bytes_by_class.get("kv", 0)
        refunded0 = eng.clock.refunded_bytes
        assert eng.preempt(0)
        (rid, entry), = eng._spilled.items()
        assert len(entry.resv) > 1
        if phase == "restore":
            eng._admit()
            assert entry.phase == "restoring" and entry.slot == 0
        free = len(eng._free)
        assert rt.cancel(rid)
        assert eng.clock.refunded_bytes - refunded0 == entry.nbytes
        assert len(eng._free) == free + (phase == "restore")
        if phase == "spill":
            assert link.bytes_by_class["kv"] == kv0
        assert rid not in eng.kv_pool and not eng._spilled
        assert entry.req.status == "cancelled"
        rt.drain()
        assert not eng.busy
        seen.append((entry.nbytes, _links(eng.clock),
                     dataclasses.asdict(eng.kv_pool.stats()),
                     dataclasses.asdict(eng.store.stats()),
                     [r.out for r in eng.done.values()],
                     [getattr(eng.stats, f) for f in STATS_FIELDS]))
    assert seen[0] == seen[1]


def test_overload_options_refused(weights):
    """Preemption and idle spill refuse speculation, idle spill refuses
    chunked admission, and a fabric needs a pool tier."""
    kw = dict(params=weights[1], device="cpu")
    cfg = _tiny(deepseek_7b)
    from repro_torch.serving import Engine
    with pytest.raises(ValueError, match="speculative"):
        Engine(cfg, slo_policy=slo.OverloadPolicy(), spec=SpecConfig(), **kw)
    with pytest.raises(ValueError, match="speculative"):
        Engine(cfg, idle_spill_tokens=4, spec=SpecConfig(), **kw)
    with pytest.raises(ValueError, match="monolithic"):
        Engine(cfg, idle_spill_tokens=4, prefill_chunk=4, **kw)
    with pytest.raises(ValueError, match="pooled tier"):
        Engine(cfg, fabric_nodes=2, **kw)
    # a policy without preemption composes with speculation
    eng = Engine(cfg, slo_policy=slo.OverloadPolicy(preempt=False),
                 spec=SpecConfig(), **kw)
    assert eng.kv_pool is None
    assert Engine(cfg, idle_spill_tokens=4, **kw).kv_pool.capacity_bytes \
        == 1 << 30
