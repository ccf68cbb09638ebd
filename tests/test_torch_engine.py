"""PyTorch port vs the JAX reference: the serving engine on the CPU.

On the tiny serving config (tests/test_serving.py), with weights bridged
from the reference, the port's ``Engine(device="cpu")`` must emit the
reference ``Engine``'s token streams exactly and leave equal ``StoreStats``,
with and without a pool tier; a steady pool decode wave reads the device
once (tests/test_hotpath.py's budget). Also: the port runs on the card by
default, takes the reference's fleet options, raises for options later
slices port, and imports nothing of JAX or of the JAX package."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.configs import engram_27b as ref_engram_27b  # noqa: E402
from repro.models.model import init_params as ref_init_params  # noqa: E402
from repro.pool.store import TableFetcher as RefTableFetcher  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro_torch.configs import SpecConfig, StoreConfig  # noqa: E402
from repro_torch.configs import deepseek_7b, engram_27b  # noqa: E402
from repro_torch.kernels.engram_gather import gather_rows  # noqa: E402
from repro_torch.kernels.gated_fuse import engram_gated_fuse  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.pool.store import TableFetcher, fetch_layers  # noqa: E402
from repro_torch.models.layers import with_f32_head  # noqa: E402
from repro_torch.pool.store import make_store  # noqa: E402
from repro_torch.serving import Engine, OverloadPolicy  # noqa: E402
from repro_torch.serving import VirtualClock  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402

torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"
PROMPTS = [[5, 17, 42], [7, 8, 9, 10], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
           [11, 12], [20, 30, 40, 50, 60]]


def _tiny(mod):
    """tests/test_serving.py's tiny config: 3 layers, Engram at layer 1."""
    cfg = mod.reduced()
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3,
                               engram=dataclasses.replace(cfg.engram,
                                                          layers=(1,)))


@pytest.fixture(scope="module")
def setup():
    cfg, rcfg = _tiny(deepseek_7b), _tiny(ref_deepseek_7b)
    rparams = ref_init_params(rcfg, 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, rcfg, rparams, params


def _serve(engine):
    rids = [engine.submit(list(p), max_new=6) for p in PROMPTS]
    engine.run()
    return [engine.done[r].out for r in rids]


@pytest.mark.parametrize("pool", [None, "CXL"])
def test_engine_matches_reference(setup, pool):
    """3 slots, 5 requests (continuous batching with refills): identical
    greedy streams and field-by-field equal StoreStats."""
    cfg, rcfg, rparams, params = setup
    ref = RefEngine(rcfg, params=rparams, max_batch=3, max_len=64,
                    prompt_bucket=8, pool=pool)
    want = _serve(ref)
    gather_rows.launches = 0
    engram_gated_fuse.launches = 0
    eng = Engine(cfg, params=params, max_batch=3, max_len=64,
                 prompt_bucket=8, pool=pool, device="cpu")
    got = _serve(eng)
    assert got == want
    assert all(len(s) == 6 for s in got)
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(ref.store.stats())
    assert eng.stats.generated_tokens == ref.stats.generated_tokens == 30
    assert eng.stats.decode_steps == ref.stats.decode_steps
    # the CPU path runs the kernels' plain versions: no launch
    assert gather_rows.launches == 0 and engram_gated_fuse.launches == 0


def test_emulated_operating_point_matches_reference(setup):
    """At the emulated point the timeline is deterministic: the virtual
    clock, the CXL link bookings and the scaled prefill charges must land
    on exactly the reference's numbers."""
    cfg, rcfg, rparams, params = setup
    kw = dict(max_batch=3, max_len=64, prompt_bucket=8, pool="CXL",
              emulate_step_s=5e-5, emu_prefill_scaled=True)
    ref = RefEngine(rcfg, params=rparams, **kw)
    want = _serve(ref)
    eng = Engine(cfg, params=params, device="cpu", **kw)
    assert _serve(eng) == want
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(ref.store.stats())
    assert eng.store.stats().class_bytes["engram"] > 0   # link-bound
    for f in ("emu_time_s", "v_time_s", "ttft_v_sum", "stall_s"):
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    assert eng.clock.stats() == ref.clock.stats()


def test_decode_wave_single_read(setup):
    """Steady-state pool decode = exactly ONE device->host read."""
    cfg, _, _, params = setup
    eng = Engine(cfg, params=params, max_batch=2, max_len=64,
                 prompt_bucket=8, pool="CXL", emulate_step_s=5e-5,
                 device="cpu")
    rt = eng.runtime()
    h = rt.submit([5, 17, 42], max_new=10)
    rt.step()                     # admission + post-admission decode
    for _ in range(3):            # steady state
        before = eng.stats.d2h_pulls
        rt.step()
        assert eng.stats.d2h_pulls - before == 1
    assert h.result() == eng.done[h.rid].out and len(h.tokens) == 10


def test_table_fetcher_padded_rows(setup):
    """F3: row ids honour the padded table vocab, as the reference's."""
    cfg, rcfg, rparams, params = setup
    e = cfg.engram
    tab = params["engram"]["layers"][0]["tables"]
    fetcher = TableFetcher(e, tab)
    ref = RefTableFetcher(rcfg.engram, rparams["engram"]["layers"][0]["tables"])
    assert fetcher.V > e.table_vocab
    keys = np.random.RandomState(0).randint(0, e.table_vocab, size=(4, 16)) \
        + np.arange(16) * e.table_vocab
    np.testing.assert_array_equal(fetcher.gid_for(keys), ref.gid_for(keys))
    np.testing.assert_array_equal(fetcher(keys).numpy(),
                                  np.asarray(ref(keys)))
    with pytest.raises(IndexError):
        fetcher(gid=np.array([fetcher.T * fetcher.V]))


def test_fetch_layers_bit_equal_to_reference_fetchers():
    """The wave's one multi-table gather (CPU: K1's plain version) returns,
    for each Engram layer of the reduced engram-27b config, exactly the
    rows of the reference's per-layer ``TableFetcher``."""
    cfg, rcfg = engram_27b.reduced(), ref_engram_27b.reduced()
    e = cfg.engram
    rparams = ref_init_params(rcfg, 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    layers = params["engram"]["layers"]
    assert len(layers) == len(cfg.engram_layers()) == 2
    fetchers = [TableFetcher(e, lay["tables"]) for lay in layers]
    rng = np.random.RandomState(5)
    keys = [rng.randint(0, e.table_vocab, size=(6, e.n_tables))
            + (np.arange(e.n_tables) + j * e.n_tables) * e.table_vocab
            for j in range(2)]
    got = fetch_layers(fetchers, [f.gid_for(k) for f, k in
                                  zip(fetchers, keys)])
    assert tuple(got.shape) == (2, 6 * e.n_tables, e.head_dim)
    for j, lay in enumerate(rparams["engram"]["layers"]):
        ref = RefTableFetcher(rcfg.engram, lay["tables"])
        np.testing.assert_array_equal(got[j].numpy(), np.asarray(ref(keys[j])))
    with pytest.raises(IndexError):
        fetch_layers(fetchers, [[0], [fetchers[1].T * fetchers[1].V]])


def _two_engram_layers(mod):
    cfg = _tiny(mod)
    return dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, layers=(1, 2)))


def test_decode_wave_fetches_every_layer_in_one_call(monkeypatch):
    """Pool mode with two Engram layers: each decode wave makes ONE fused
    fetch (one K1 launch on the card) for both layers, and the engine
    still emits the reference's streams with equal StoreStats."""
    cfg = _two_engram_layers(deepseek_7b)
    rcfg = _two_engram_layers(ref_deepseek_7b)
    rparams = ref_init_params(rcfg, 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    calls = []

    def counting(fetchers, gids):
        calls.append(len(fetchers))
        return fetch_layers(fetchers, gids)

    monkeypatch.setattr(engine_mod, "fetch_layers", counting)
    kw = dict(max_batch=3, max_len=64, prompt_bucket=8, pool="CXL")
    ref = RefEngine(rcfg, params=rparams, **kw)
    want = _serve(ref)
    eng = Engine(cfg, params=params, device="cpu", **kw)
    assert _serve(eng) == want
    assert calls == [2] * eng.stats.decode_steps
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(ref.store.stats())


def test_cancel_queued_and_running(setup):
    cfg, _, _, params = setup
    eng = Engine(cfg, params=params, max_batch=1, max_len=64,
                 prompt_bucket=8, device="cpu")
    rt = eng.runtime()
    a = rt.submit([1, 2, 3], max_new=5)
    b = rt.submit([4, 5, 6], max_new=5)
    rt.step()
    assert rt.cancel(b) and b.cancelled           # still queued
    assert rt.cancel(a) and a.cancelled           # running
    assert not eng.busy and not rt.cancel(a)


def test_engine_defaults_to_the_card(setup):
    """Without ``device`` the engine runs on CUDA; with none it raises
    instead of quietly running on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg, _, _, params = setup
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params=params)


def test_unported_options_raise(setup):
    cfg, _, _, params = setup
    kw = dict(params=params, device="cpu")
    # ported since: chunked prefill, the hot-row cache, speculation,
    # overload and KV spill, tier chains and the fabric
    assert Engine(cfg, prefill_chunk=4, **kw).prefill_chunk == 4
    assert Engine(cfg, spec=SpecConfig(), **kw).spec == SpecConfig()
    cached = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=64)))
    assert Engine(cached, pool="CXL", **kw).store.stats().cache_rows == 64
    assert Engine(cfg, idle_spill_tokens=64, **kw).idle_spill_tokens == 64
    assert Engine(cfg, slo_policy=OverloadPolicy(), **kw).kv_pool is not None
    assert Engine(cfg, pool="CXL", fabric_nodes=2, **kw).fabric.n_nodes == 2
    chain = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(warm_rows=64)))
    assert Engine(chain, pool="CXL+SSD", **kw).store.stats().tier == \
        "CXL+SSD"
    with pytest.raises(TypeError):
        Engine(cfg, no_such_option=1, **kw)
    # the fleet options (ported with the router): the store and clock
    # passed in are the ones used, rids count up from rid_start as in the
    # reference, the name labels the cursor, the hint seeds the estimate
    assert not hasattr(engine_mod, "_UNPORTED")
    clock = VirtualClock()
    store = make_store(cfg.engram, "CXL", clock=clock)
    eng = Engine(cfg, pool="CXL", store=store, clock=clock, name="r0",
                 rid_start=5, step_latency_hint_s=0.01, max_batch=1,
                 max_len=64, prompt_bucket=8, **kw)
    assert eng.store is store and eng.clock is clock and eng.name == "r0"
    assert store.cursor is eng.cursor and "r0" in clock.stats()["cursors"]
    assert eng._step_estimate_s() == 0.01
    assert eng.submit([1, 2], max_new=2) == 6
    ref = RefEngine(setup[1], params=setup[2], rid_start=5,
                    name="r0", max_batch=1, max_len=64, prompt_bucket=8)
    assert ref.submit([1, 2], max_new=2) == 6
    stats = eng.run()
    assert list(eng.done) == [6] and stats.generated_tokens == 2
    assert Engine(cfg, **kw).name is None
    eng = Engine(cfg, max_batch=1, max_len=64, prompt_bucket=8, **kw)
    eng.submit([1, 2], max_new=2, arrival_s=1.0, klass="zipf",
               slo="interactive")
    req = eng.queue[-1]
    assert (req.submitted_v, req.klass, req.slo) == (1.0, "zipf",
                                                     "interactive")
    assert eng.cursor.now_s == 1.0


def test_engines_share_one_f32_head(setup):
    """``with_f32_head`` keeps a ``w32`` the tree already holds: engines
    built from one prepared tree share one f32 head (the router's replicas),
    and an f32 head is the head itself, not a copy."""
    cfg, _, _, params = setup
    kw = dict(max_batch=1, max_len=64, prompt_bucket=8, device="cpu")
    bf16 = dict(params, head={"w": params["head"]["w"].bfloat16()})
    prepared = with_f32_head(bf16)
    assert with_f32_head(prepared) is prepared
    a, b = (Engine(cfg, params=prepared, **kw) for _ in range(2))
    assert a.params["head"]["w32"] is b.params["head"]["w32"] \
        is prepared["head"]["w32"]
    assert a.params["head"]["w32"].dtype == torch.float32
    f32 = Engine(cfg, params=params, **kw).params["head"]
    assert f32["w32"].data_ptr() == params["head"]["w"].data_ptr()


def test_port_imports_nothing_of_jax():
    """Every module of repro_torch imports without pulling in jax or any
    module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.pool.cache' in sys.modules\n"
        "assert 'repro_torch.spec.proposer' in sys.modules\n"
        "assert 'repro_torch.spec.verifier' in sys.modules\n"
        "for m in ('pool.cost', 'pool.kvpool', 'pool.tierchain', "
        "'pool.fabric', 'serving.slo', 'serving.router', 'serving.api', "
        "'serving.workload', 'pool.feasibility', 'pool.simulator', "
        "'launch.serve', 'launch.train', 'launch.mesh', "
        "'examples.serve_pooled', 'examples.serve_router', "
        "'sharding.rules', 'sharding.collectives', 'data.pipeline', "
        "'train.optimizer', 'train.loop', 'train.compress', 'train.ddp', "
        "'checkpoint.checkpointer', 'examples.quickstart', "
        "'examples.train_engram_lm', 'core.engram', 'models.model', "
        "'models.layers', 'models.moe', 'models.params', "
        "'roofline.analysis', 'roofline.counting', 'roofline.report', "
        "'launch.specs', 'launch.dryrun', 'examples.multipod_dryrun', "
        "'experiments.hillclimb'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20
