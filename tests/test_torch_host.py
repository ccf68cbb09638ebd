"""PyTorch port vs the JAX reference: the ``pooled_host`` strategy and the
configs that need it at full width (engram-40b, deepseek-coder-33b).

On the CPU a host table is a plain CPU tensor and K1 runs its plain
version, so these tests hold the port's semantics to the reference's:
``retrieve(..., "pooled_host")`` gathers the same rows as the reference's
(bit-equal, fp32), each strategy resolves to the same store tier, the
reduced configs equal the reference's field by field (the full ones are
in ``tests/test_torch_model.py``), prefill logits match
(allclose at fp32: sums in another order), and ``Engine(pool="CXL")`` with
``RunFlags(engram_strategy="pooled_host")`` emits the reference engine's
streams with equal ``StoreStats`` and clock at the emulated point. The
card's side (K1 reading mapped host memory) is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.pool as ref_pool  # noqa: E402
from repro.configs import deepseek_coder_33b as ref_coder  # noqa: E402
from repro.configs import engram_40b as ref_e40  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ENGRAM_40B as REF_ENGRAM_40B  # noqa: E402
from repro.core import engram as ref_engram  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
import repro_torch.pool as port_pool  # noqa: E402
from repro_torch.configs import ENGRAM_40B, SpecConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import deepseek_coder_33b, engram_40b  # noqa: E402
from repro_torch.core import engram as port_engram  # noqa: E402
from repro_torch.core.hashing import engram_indices  # noqa: E402
from repro_torch.kernels.engram_gather import gather_rows  # noqa: E402
from repro_torch.kernels.engram_gather import is_mapped  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.params import (from_jax, init_params,  # noqa: E402
                                       tables_to_host, tree_leaves)
from repro_torch.models.transformer import RunFlags  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

torch.set_num_threads(2)

CONFIGS = {
    "engram-40b-reduced": (engram_40b.reduced(), ref_e40.reduced()),
    "deepseek-coder-33b-reduced": (deepseek_coder_33b.reduced(),
                                   ref_coder.reduced()),
}
HOST, REF_HOST = RunFlags(engram_strategy="pooled_host"), \
    RefFlags(engram_strategy="pooled_host")
STRATEGIES = ("local", "local_kernel", "tp", "pooled", "pooled_host")
PROMPTS = [[5, 17, 42], [7, 8, 9, 10], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
           [11, 12], [20, 30, 40, 50, 60]]
LOGITS = dict(rtol=1e-4, atol=1e-4)   # f32 sums in another order, 4-6 layers


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def bridged(request):
    """(port cfg, ref cfg, ref params, port params bridged from them)."""
    cfg, rcfg = CONFIGS[request.param]
    rparams = ref_model.init_params(rcfg, 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, rcfg, rparams, params


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reduced_configs_identical(name):
    cfg, rcfg = CONFIGS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()


def test_engram_presets_match_paper():
    """Twin of tests/test_configs.py::test_engram_presets_match_paper."""
    e27 = get_config("engram-27b").engram
    assert e27.table_vocab == 2_262_400 and e27.emb_dim == 1280
    e40 = get_config("engram-40b").engram
    assert e40.table_vocab == 7_239_680 and e40.emb_dim == 1280
    assert ENGRAM_40B == REF_ENGRAM_40B


def test_full_width_shapes():
    """What the card serves: coder-33b has d 7168, 56 heads, vocab 32,256,
    rope theta 1e5 and the ENGRAM_27B tables at layers 2 and 26; both
    configs pass the port's family check."""
    c33, e40 = get_config("deepseek-coder-33b"), get_config("engram-40b")
    assert (c33.d_model, c33.n_heads, c33.vocab_size, c33.rope_theta) == \
        (7168, 56, 32_256, 100_000.0)
    assert c33.engram_layers() == (2, 26) and e40.engram_layers() == (2, 17)
    assert port_engram.padded_vocab(c33.engram) == 2_265_088
    assert port_engram.padded_vocab(e40.engram) == 7_241_728
    for cfg in (c33, e40):
        port_model.model_defs(cfg)


# ---------------------------------------------------------------- retrieval

def test_retrieve_pooled_host_matches_reference(bridged):
    """The reference's pooled_host (a gather under compute_on, jitted) and
    the port's give the same rows, bit for bit, equal to local's."""
    cfg, _, rparams, params = bridged
    e = cfg.engram
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(3, 7))
    ridx = np.asarray(ref_engram.engram_indices(e, jnp.asarray(toks)))
    idx = engram_indices(e, torch.from_numpy(toks))
    np.testing.assert_array_equal(idx.numpy(), ridx)
    for slot, layer in enumerate(params["engram"]["layers"]):
        rtab = rparams["engram"]["layers"][slot]["tables"]
        want = jax.jit(lambda t, i: ref_engram.retrieve(
            e, t, i, "pooled_host"))(rtab, jnp.asarray(ridx))
        got = port_engram.retrieve(e, layer["tables"], idx, "pooled_host")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            got.numpy(), port_engram.retrieve(e, layer["tables"], idx,
                                              "local").numpy())


def test_retrieve_host_refuses_device_tables():
    """pooled_host is a placement: tables anywhere but host memory raise."""
    e = CONFIGS["engram-40b-reduced"][0].engram
    tables = torch.empty((e.n_tables, 8, e.head_dim), device="meta")
    with pytest.raises(ValueError, match="host memory"):
        port_engram.retrieve_host(e, tables, torch.zeros(1, 1, e.n_tables,
                                                         dtype=torch.long))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_store_tiers(strategy):
    """Twin of tests/test_store.py::test_strategy_resolves_through_store,
    for every strategy: the same store class and tier as the reference."""
    e, re_ = get_config("engram-27b").engram, ref_get_config(
        "engram-27b").engram
    assert port_pool.STRATEGY_TIERS[strategy] == \
        ref_pool.STRATEGY_TIERS[strategy]
    for got, want in ((port_engram.strategy_store(e, strategy),
                       ref_engram.strategy_store(re_, strategy)),
                      (port_pool.store_for_strategy(e, strategy),
                       ref_pool.store_for_strategy(re_, strategy))):
        assert type(got).__name__ == type(want).__name__
        assert got.stats().tier == want.stats().tier
        assert isinstance(got, port_pool.EngramStore)
    assert port_engram.STRATEGIES[strategy].name == strategy


def test_pool_exports_match_reference():
    """The port's pool package exports every name the reference's does."""
    want = {n for n in dir(ref_pool) if not n.startswith("_")}
    assert want <= set(dir(port_pool))
    assert {"EngramStore", "STRATEGY_TIERS", "store_for_strategy"} <= \
        set(port_pool.__all__)


# ------------------------------------------------------------ model, engine

def test_prefill_logits_match_reference(bridged):
    cfg, rcfg, rparams, params = bridged
    rng = np.random.RandomState(1)
    toks = rng.randint(1, cfg.vocab_size, size=(2, 9))
    rpre = ref_model.build_prefill_step(rcfg, REF_HOST, max_len=16)
    want, _ = jax.jit(rpre)(rparams, {"tokens": jnp.asarray(toks)})
    pre = port_model.build_prefill_step(cfg, HOST, max_len=16)
    got, _ = pre(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def _serve(engine, max_new=6):
    rids = [engine.submit(list(p), max_new=max_new) for p in PROMPTS]
    engine.run()
    return [engine.done[r].out for r in rids]


def test_engine_pooled_host_matches_reference(bridged):
    """pool="CXL" with pooled_host at the emulated point: the reference
    engine's streams, StoreStats, counters and clock, exactly."""
    cfg, rcfg, rparams, params = bridged
    kw = dict(max_batch=3, max_len=64, prompt_bucket=8, pool="CXL",
              emulate_step_s=5e-5, emu_prefill_scaled=True)
    ref = RefEngine(rcfg, params=rparams, flags=REF_HOST, **kw)
    want = _serve(ref)
    gather_rows.launches = 0
    eng = Engine(cfg, params=params, flags=HOST, device="cpu", **kw)
    assert _serve(eng) == want
    assert all(len(s) == 6 for s in want)
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(ref.store.stats())
    for f in ("generated_tokens", "decode_steps", "prefill_waves",
              "emu_time_s", "v_time_s", "ttft_v_sum", "stall_s"):
        assert getattr(eng.stats, f) == getattr(ref.stats, f), f
    assert eng.clock.stats() == ref.clock.stats()
    assert gather_rows.launches == 0           # the CPU: plain version


@pytest.mark.parametrize("mode", ["pool_none", "chunked", "spec"])
def test_engine_paths_pooled_host_equal_local(bridged, mode):
    """The other retrieval paths, pool=None decode, chunk waves and the
    pool=None block path of verify waves, give the same streams under
    pooled_host as under local."""
    cfg, _, _, params = bridged
    kw = dict(max_batch=3, max_len=64, prompt_bucket=8, device="cpu",
              pool=None if mode in ("pool_none", "spec") else "CXL")
    if mode == "chunked":
        kw.update(prefill_chunk=4)
    if mode == "spec":
        kw.update(spec=SpecConfig(proposer="ngram", max_draft=2))
    want = _serve(Engine(cfg, params=params, **kw), max_new=4)
    assert _serve(Engine(cfg, params=params, flags=HOST, **kw),
                  max_new=4) == want


def test_engine_refuses_misplaced_tables(bridged):
    """Tables the engine's device cannot read as the strategy says raise
    (here on the CPU: tables that are not CPU tensors); the card's cases
    are in tests/test_torch_cuda.py."""
    cfg, _, _, params = bridged
    bad = dict(params, engram={"layers": [
        dict(layer, tables=torch.empty(layer["tables"].shape,
                                       device="meta"))
        for layer in params["engram"]["layers"]]})
    for flags in (HOST, RunFlags()):
        with pytest.raises(ValueError, match="tables live in"):
            Engine(cfg, params=bad, flags=flags, device="cpu", max_batch=2,
                   max_len=32, prompt_bucket=8)


def test_pinned_host_placement_on_cpu():
    """On the CPU table_memory="pinned_host" leaves plain CPU tensors with
    the bytes of a plain draw, and tables_to_host leaves a CPU tree as it
    is; neither maps anything."""
    cfg = CONFIGS["deepseek-coder-33b-reduced"][0]
    a = init_params(cfg, 3, "cpu")
    b = init_params(cfg, 3, "cpu", table_memory="pinned_host")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    tables = [layer["tables"] for layer in b["engram"]["layers"]]
    assert tables_to_host(b) is b
    assert all(layer["tables"] is t
               for layer, t in zip(b["engram"]["layers"], tables))
    assert not any(is_mapped(t) for t in tables)
    with pytest.raises(ValueError, match="table_memory"):
        init_params(cfg, 3, "cpu", table_memory="hbm")
