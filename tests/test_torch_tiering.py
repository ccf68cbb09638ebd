"""PyTorch port vs the JAX reference: the tier chain, the pool fabric and
the cost model on the CPU.

``pool/cost.py``, ``FrequencySketch.decay``, ``TierChain``
(``pool="CXL+SSD"``), ``crc32_keys``/``shard_of``, ``PoolFabric`` and
``FabricStore`` are host code in both packages: fed the same key streams
on the same virtual clock they must route, charge and account exactly as
the reference does (routes, ``StoreStats`` ledgers, link ledgers, rescue
windows). The engine over a chain and over a two-node fabric must emit
the reference's token streams, which are the ones without tiers, with
equal ``StoreStats`` and clock. Key streams come from the reference's
``zipf_keys`` and numpy seeds; properties from hypothesis (or the
repository's stand-in)."""
import dataclasses
import zlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.configs.base import StoreConfig as RefStoreConfig  # noqa: E402
from repro.models.model import init_params as ref_init_params  # noqa: E402
from repro.pool import cache as ref_cache  # noqa: E402
from repro.pool import cost as ref_cost  # noqa: E402
from repro.pool import fabric as ref_fabric  # noqa: E402
from repro.pool import store as ref_store  # noqa: E402
from repro.pool.tiers import TIERS as REF_TIERS  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro.serving import clock as ref_clock  # noqa: E402
from repro_torch.configs import StoreConfig, deepseek_7b  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.pool import cache as port_cache  # noqa: E402
from repro_torch.pool import cost  # noqa: E402
from repro_torch.pool import fabric  # noqa: E402
from repro_torch.pool import store as port_store  # noqa: E402
from repro_torch.pool.tiers import TIERS  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.serving import clock as port_clock  # noqa: E402

torch.set_num_threads(2)

CHAIN = dict(cache_rows=32, warm_rows=256, aging_half_life_s=0.05)


def _tiny(mod, scfg=None):
    """tests/test_tiering.py's config: 3 layers, Engram at layer 1."""
    cfg = mod.reduced()
    e = dataclasses.replace(cfg.engram, layers=(1,))
    if scfg is not None:
        e = dataclasses.replace(e, store=scfg)
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3, engram=e)


# per package: (store module, StoreConfig, VirtualClock, config module,
# cache module, fabric module)
PKGS = {"port": (port_store, StoreConfig, port_clock.VirtualClock,
                 deepseek_7b, port_cache, fabric),
        "ref": (ref_store, RefStoreConfig, ref_clock.VirtualClock,
                ref_deepseek_7b, ref_cache, ref_fabric)}


def _ecfg(pkg, **scfg):
    return _tiny(PKGS[pkg][3], PKGS[pkg][1](**scfg)).engram


def _links(clock):
    """Clock ledgers with per-object link names (``chainfront:<id>``) cut."""
    st_ = clock.stats()
    links = sorted((dict(v, name=n.split(":")[0]) for n, v in
                    st_["links"].items()), key=lambda d: d["name"])
    return dict(st_, links=links)


# ------------------------------------------------------------- cost model

@pytest.mark.parametrize("readers,nnodes,pool_nodes",
                         [(1, 1, None), (4, 2, None), (4, 4, 1), (8, 2, 3),
                          (3, 5, 2)])
def test_cost_model_matches_reference(readers, nnodes, pool_nodes):
    """The contended budget, the contended tier and the capital costs."""
    for bw in (56e9, 12.5e9):
        assert cost.contended_bandwidth_Bps(bw, readers, nnodes,
                                            pool_nodes=pool_nodes) == \
            ref_cost.contended_bandwidth_Bps(bw, readers, nnodes,
                                             pool_nodes=pool_nodes)
    t = cost.contended_tier(TIERS["CXL"], readers, nnodes,
                            pool_nodes=pool_nodes)
    r = ref_cost.contended_tier(REF_TIERS["CXL"], readers, nnodes,
                                pool_nodes=pool_nodes)
    assert dataclasses.astuple(t) == dataclasses.astuple(r)
    for gb in (200.0, 800.0):
        assert cost.local_cost(gb, readers) == ref_cost.local_cost(gb, readers)
        assert cost.pool_cost(gb, readers) == ref_cost.pool_cost(gb, readers)
        assert cost.chain_cost(gb / 8, gb / 2, gb, nnodes) == \
            ref_cost.chain_cost(gb / 8, gb / 2, gb, nnodes)
        assert cost.breakeven_nodes(gb) == ref_cost.breakeven_nodes(gb)
    assert cost.CXL_SWITCH_BW_Bps == ref_cost.CXL_SWITCH_BW_Bps
    assert cost.DEFAULT_PRICES == ref_cost.DEFAULT_PRICES
    assert [dataclasses.astuple(x) for x in cost.cost_table()] == \
        [dataclasses.astuple(x) for x in ref_cost.cost_table()]
    assert cost.cost_table()[0].savings_usd == \
        ref_cost.cost_table()[0].savings_usd


# ----------------------------------------------------------- sketch aging

def test_sketch_decay_matches_reference():
    """Two port sketches fed one stream estimate alike (fixed seeds, no
    salted hash); decay halves once per whole half-life of clock time,
    catching up on a long gap, never more, as the reference's does; with
    aging off it is a no-op."""
    a, b = port_cache.FrequencySketch(), port_cache.FrequencySketch()
    keys = ref_cache.zipf_keys(512, 4096, alpha=1.0, seed=3)
    a.observe(keys)
    b.observe(keys)
    probe = np.arange(64, dtype=np.int64)
    assert np.array_equal(a.estimate(probe), b.estimate(probe))
    port = port_cache.FrequencySketch(decay_half_life_s=1.0)
    ref = ref_cache.FrequencySketch(decay_half_life_s=1.0)
    for s in (port, ref):
        for _ in range(8):
            s.observe([42])
        s.observe(keys)
    for now, halvings in ((0.5, 0), (1.0, 1), (1.999, 0), (3.2, 2),
                          (3.2, 0), (7.0, 4), (7.5, 0), (8.0, 1)):
        assert port.decay(now) == ref.decay(now) == halvings
        assert np.array_equal(port.estimate(probe), ref.estimate(probe))
        assert port._ops == ref._ops
    assert int(port.estimate([42])[0]) == 0
    off = port_cache.FrequencySketch()
    off.observe([42])
    assert off.decay(100.0) == 0 and int(off.estimate([42])[0]) == 1


# ------------------------------------------------------------- tier chain

def _chain(pkg, spec="CXL+SSD", **scfg):
    smod, scls, vclock = PKGS[pkg][:3]
    clock = vclock()
    cur = clock.cursor("test")
    store = smod.make_store(_ecfg(pkg, **scfg), spec,
                            store_cfg=scls(**scfg), clock=clock)
    store.bind_cursor(cur)
    return store, cur, clock


def _drive(store, cur, waves, *, t0=0.0, perm=None, gap_s=1e-3):
    routes = []
    for i in range(waves):
        cur.advance_to(t0 + i * gap_s)
        cur.next_wave()
        keys = ref_cache.zipf_keys(128, 2048, alpha=1.0, seed=i)
        if perm is not None:
            keys = perm[keys]
        h = store.prefetch(keys)
        routes.append((h.shards, h.latency_s, h.wait_s))
    return routes


@pytest.mark.parametrize("spec,scfg", [
    ("CXL+SSD", CHAIN),
    ("CXL+SSD", dict(cache_rows=0, warm_rows=128)),
    ("DRAM+CXL+SSD", dict(CHAIN, aging_half_life_s=0.0)),
    ("RDMA+SSD", dict(cache_rows=16, warm_rows=64, aging_half_life_s=4e-3)),
])
def test_chain_matches_reference(spec, scfg):
    """Wave by wave the same route (front, warm, cold, promote, demote),
    latency and wait; the same StoreStats ledgers, residency and link
    ledgers; routes conserve the wave's unique keys."""
    (port, cur, clock), (ref, rcur, rclock) = \
        _chain("port", spec, **scfg), _chain("ref", spec, **scfg)
    got = _drive(port, cur, 24)
    assert got == _drive(ref, rcur, 24)
    for i, (route, _, _) in enumerate(got):
        uniq = np.unique(ref_cache.zipf_keys(128, 2048, alpha=1.0,
                                             seed=i)).size
        front, warm, cold, promote, demote, split = route
        assert front + warm + cold == uniq and promote <= cold
        assert split is None
    assert dataclasses.asdict(port.stats()) == dataclasses.asdict(ref.stats())
    assert list(port._warm) == list(ref._warm)
    assert list(port._front) == list(ref._front)
    assert _links(clock) == _links(rclock)
    s = port.stats()
    assert s.warm_hits > 0 and s.cold_misses > 0 and s.promotions > 0
    assert s.promotions - s.demotions == len(port._warm) <= port.warm_rows
    assert (s.hits > 0) == (port.front_rows > 0)
    for klass in ("engram", "promote"):
        assert s.class_bytes[klass] > 0 and s.class_busy_s[klass] > 0
    port.reset_stats()
    assert port.stats().tier == spec and port.stats().promotions == 0
    assert port.stats().cache_rows == port.front_rows


def test_chain_requires_warm_rows():
    for pkg in ("port", "ref"):
        with pytest.raises(AssertionError, match="warm_rows"):
            _chain(pkg, cache_rows=8, warm_rows=0)


def test_chain_scan_resistance_matches_reference():
    """A one-shot scan cannot displace an established hot set (strict
    promotion, gated front): no demotion, the same residency before and
    after, zero cold misses on the hot set after the scan."""
    out = []
    for pkg in ("port", "ref"):
        store, cur, _ = _chain(pkg, **CHAIN)
        hot = np.arange(CHAIN["warm_rows"], dtype=np.int64)
        for i in range(6):
            cur.advance_to(i * 1e-4)
            cur.next_wave()
            store.prefetch(hot)
        warm, front = list(store._warm), list(store._front)
        cur.advance_to(7e-4)
        cur.next_wave()
        scan = store.prefetch(np.arange(10_000, 10_400, dtype=np.int64))
        assert scan.shards[4] == 0
        assert (list(store._warm), list(store._front)) == (warm, front)
        cur.advance_to(8e-4)
        cur.next_wave()
        after = store.prefetch(hot)
        assert after.shards[2] == 0
        out.append((scan.shards, after.shards,
                    dataclasses.asdict(store.stats())))
    assert out[0] == out[1]


def test_chain_aging_recovers_from_hot_set_shift():
    """After the hot set is relabelled, the aged chain re-places it while
    the never-forgetting one stays frozen on stale rows; both exactly as
    the reference's chains."""
    perm = np.random.default_rng(123).permutation(2048).astype(np.int64)

    def hit_share(pkg, half_life):
        store, cur, _ = _chain(pkg, **dict(CHAIN,
                                           aging_half_life_s=half_life))
        _drive(store, cur, 30)
        tail = [r for r, _, _ in _drive(store, cur, 30, t0=30e-3,
                                        perm=perm)][-8:]
        return sum(r[0] + r[1] for r in tail) / \
            sum(r[0] + r[1] + r[2] for r in tail)

    aged, frozen = hit_share("port", 4e-3), hit_share("port", 0.0)
    assert aged > frozen + 0.05
    assert (aged, frozen) == (hit_share("ref", 4e-3), hit_share("ref", 0.0))


def test_chain_replay_rebooks_identically():
    """Recorded routes replayed as ``Segments`` re-book every link to the
    same charge, leaving residency and the sketch untouched; the replayed
    handles, stats and links equal the reference's replay."""
    src, cur, _ = _chain("port", **CHAIN)
    routes = [r for r, _, _ in _drive(src, cur, 12)]
    out = []
    for pkg in ("port", "ref"):
        store, cur2, clock = _chain(pkg, **CHAIN)
        smod = PKGS[pkg][0]
        for i, r in enumerate(routes):
            cur2.advance_to(i * 1e-3)
            cur2.next_wave()
            h = store.prefetch(smod.Segments(r[0], r[1] + r[2], shards=r))
            assert h.shards == r
        assert len(store._warm) == 0
        out.append((dataclasses.asdict(store.stats()), _links(clock)))
        a = src.stats()
        assert (a.promotions, a.demotions, a.class_bytes) == \
            (store.stats().promotions, store.stats().demotions,
             store.stats().class_bytes)
    assert out[0] == out[1]


# ---------------------------------------------------------- shard routing

def test_crc32_keys_pinned_and_equal_to_zlib():
    keys = np.array([0, 1, -1, 2**31, -(2**31), 123456789123,
                     2**63 - 1, -(2**63)], np.int64)
    want = np.array([zlib.crc32(k.astype("<i8").tobytes()) for k in keys],
                    np.uint32)
    assert np.array_equal(fabric.crc32_keys(keys), want)
    assert np.array_equal(fabric.crc32_keys(keys),
                          ref_fabric.crc32_keys(keys))
    assert fabric.shard_of(np.arange(16), 4).tolist() == \
        [1, 3, 0, 2, 3, 1, 2, 0, 0, 2, 1, 3, 2, 0, 3, 1]


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(min_value=-(2**62), max_value=2**62),
                min_size=1, max_size=64),
       st.integers(min_value=1, max_value=7))
def test_shard_routing_matches_zlib_and_reference(keys, n_shards):
    """Property (tests/test_fabric.py's strategy): per key the crc32 is
    zlib's and the reference's, and routing is a total function onto
    [0, n_shards) whose counts partition the stream."""
    a = np.asarray(keys, np.int64)
    crc = fabric.crc32_keys(a)
    assert [int(c) for c in crc] == \
        [zlib.crc32(np.int64(k).astype("<i8").tobytes()) for k in keys]
    assert np.array_equal(crc, ref_fabric.crc32_keys(a))
    s = fabric.shard_of(a, n_shards)
    assert np.array_equal(s, ref_fabric.shard_of(a, n_shards))
    assert ((s >= 0) & (s < n_shards)).all()
    assert np.bincount(s, minlength=n_shards).sum() == a.size


# ------------------------------------------------------------- the fabric

def _fabric(pkg, n_nodes, clocked=True, **kw):
    vclock, fmod = PKGS[pkg][2], PKGS[pkg][5]
    clock = vclock() if clocked else None
    fab = fmod.PoolFabric(_ecfg(pkg), n_nodes, clock=clock, **kw)
    return fab, clock


@pytest.mark.parametrize("n_nodes,n_shards", [(1, None), (4, None), (3, 7)])
def test_fabric_split_and_charge_match_reference(n_nodes, n_shards):
    """Split, even split, geometry and the max-over-shards charge, clocked
    and analytic, with a degraded node and after it heals."""
    (fab, clock), (rfab, rclock) = (
        _fabric(p, n_nodes, n_shards=n_shards) for p in ("port", "ref"))
    keys = np.unique(ref_cache.zipf_keys(3000, 1 << 20, alpha=1.05, seed=5))
    assert np.array_equal(fab.split(keys), rfab.split(keys))
    assert fab.split(keys).sum() == keys.size
    for n in (0, 1, 7, 5000):
        assert np.array_equal(fab.even_split(n), rfab.even_split(n))
    assert (fab.table_bytes, fab.shard_bytes, fab.rescue_copy_s) == \
        (rfab.table_bytes, rfab.shard_bytes, rfab.rescue_copy_s)
    for t, factor in ((0.0, 1.0), (1e-5, 8.0), (2e-5, 1.0)):
        if factor != 1.0 or t:
            fab.degrade(0, factor)
            rfab.degrade(0, factor)
        for clocked in (True, False):
            for split in (fab.split(keys), fab.even_split(999)):
                got = fab.charge(split, now_s=t, wave=("w", t),
                                 clocked=clocked)
                want = rfab.charge(split, now_s=t, wave=("w", t),
                                   clocked=clocked)
                assert got[:2] == want[:2]
                assert len(got[2]) == len(want[2])
    st_, rst = fab.stats(), rfab.stats()
    assert st_ == rst
    if n_nodes > 1:
        assert st_["events"][0]["kind"] == "degrade"


def test_fabric_kill_rescue_window_matches_reference():
    """Kill a node: its shards re-place round-robin onto survivors, each
    rescue copy is booked on the live links, reads to a moving shard pay
    the fallback tier until its copy lands, then the fabric is whole;
    every latency, horizon, placement and link ledger equal to the
    reference's."""
    out = []
    for pkg in ("port", "ref"):
        smod, _, vclock, _, _, fmod = PKGS[pkg]
        clock = vclock()
        fab = fmod.PoolFabric(_ecfg(pkg), 4, n_shards=8, clock=clock)
        store = fmod.FabricStore(_ecfg(pkg), fab)
        cur = clock.cursor("r0")
        store.bind_cursor(cur)
        keys = np.arange(1024, dtype=np.int64)
        healthy = store.prefetch(keys).latency_s
        done = fab.kill(2, now_s=0.0)
        assert done > 0.0 and done == fab.rescue_done_s()
        during = store.prefetch(keys)
        assert during.latency_s > healthy
        cur.advance_to(done)
        after = store.prefetch(keys)
        assert after.latency_s < during.latency_s
        assert all(fab.nodes[int(p)].alive for p in fab.placement)
        assert clock.links["fabric:fallback"].reservations >= 1
        with pytest.raises(AssertionError):
            fab.kill(2)
        out.append((healthy, done, during.latency_s, during.shards,
                    after.latency_s, fab.stats(), _links(clock),
                    dataclasses.asdict(store.stats())))
    assert out[0] == out[1]


def test_single_node_fabric_store_equals_tier_store():
    ecfg = _ecfg("port")
    fab = fabric.FabricStore(ecfg, fabric.PoolFabric(ecfg, 1))
    plain = port_store.TierStore(ecfg, "CXL")
    for n in (1, 7, 128, 5000):
        assert fab.latency_for_segments(n) == plain.latency_for_segments(n)
    keys = np.arange(777, dtype=np.int64)
    assert fab.prefetch(keys).latency_s == plain.prefetch(keys).latency_s


def test_cached_store_over_fabric_matches_reference():
    """A hot-row cache in front of a 4-node fabric sends its misses
    through the fabric's fan-out (even split): one reservation per node
    and one on the switch for a cold wave, and the reference's charges
    wave by wave."""
    out = []
    for pkg in ("port", "ref"):
        smod, scls, vclock, _, _, fmod = PKGS[pkg]
        e = _ecfg(pkg, cache_rows=256)
        clock = vclock()
        fab = fmod.PoolFabric(e, 4, clock=clock)
        store = smod.make_store(e, "CXL", fabric=fab)
        cur = clock.cursor("r0")
        store.bind_cursor(cur)
        assert store.backing.fabric is fab
        lat = []
        for i in range(6):
            cur.advance_to(i * 1e-5)
            cur.next_wave()
            keys = np.arange(2048, dtype=np.int64) if i == 0 else \
                ref_cache.zipf_keys(256, 4096, alpha=1.1, seed=i)
            h = store.prefetch(keys)
            lat.append((h.latency_s, h.wait_s, h.hits, h.misses))
            if i == 0:
                assert sum(clock.links[f"fabric:node{j}"].reservations
                           for j in range(4)) == 4
                assert clock.links["fabric:switch"].reservations == 1
        out.append((lat, dataclasses.asdict(store.stats()), _links(clock)))
    assert out[0] == out[1]


# ------------------------------------------------------------- the engine

@pytest.fixture(scope="module")
def weights():
    rparams = ref_init_params(_tiny(ref_deepseek_7b), 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), _tiny(deepseek_7b),
                      device="cpu")
    return rparams, params


def _serve(ref: bool, weights, pool, **kw):
    """tests/test_tiering.py's trace drive at the emulated point."""
    rparams, params = weights
    scfg = (RefStoreConfig if ref else StoreConfig)(**CHAIN)
    cfg = _tiny(ref_deepseek_7b if ref else deepseek_7b, scfg)
    common = dict(max_batch=2, max_len=32, prompt_bucket=8, pool=pool,
                  emulate_step_s=5e-5, **kw)
    eng = RefEngine(cfg, params=rparams, **common) if ref else \
        Engine(cfg, params=params, device="cpu", **common)
    rids = [eng.submit([5 + r, 17, 42], max_new=4) for r in range(4)]
    eng.run()
    return eng, [eng.done[r].out for r in rids]


@pytest.mark.parametrize("pool,nodes", [("CXL+SSD", None), ("CXL", 2),
                                        ("CXL+SSD", 2)])
def test_engine_over_tiers_matches_reference(weights, pool, nodes):
    """The engine over a chain, a two-node fabric and a chain whose warm
    level is sharded: the reference's streams (equal to the plain CXL
    engine's), StoreStats field by field, the fabric's stats, the clock
    and the trace's recorded splits."""
    kw = {"fabric_nodes": nodes} if nodes else {}
    eng, out = _serve(False, weights, pool, **kw)
    ref, rout = _serve(True, weights, pool, **kw)
    plain = _serve(False, weights, "CXL")[1]
    assert out == rout == plain
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(ref.store.stats())
    for f in ("stall_s", "emu_time_s", "v_time_s", "ttft_v_sum",
              "d2h_pulls", "decode_steps"):
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    assert _links(eng.clock) == _links(ref.clock)
    assert [w.split for w in eng.scheduler.trace] == \
        [w.split for w in ref.scheduler.trace]
    if nodes:
        assert eng.fabric.stats() == ref.fabric.stats()
        assert eng.fabric.n_nodes == nodes
    if pool == "CXL+SSD":
        assert eng.store.stats().cold_misses > 0
