"""PyTorch port vs the JAX reference: the gemma2/gemma3 family on the CPU.

On ``gemma2-27b-reduced`` (local/global alternating, attention and final
logit softcaps, post-block norms, GeGLU) and ``gemma3-1b-reduced`` (5:1
local:global, qk-norms, two RoPE bases), both with tied and scaled
embeddings and a 16-token window, in float32 with weights bridged from the
reference: configs and shapes field by field, the bf16 embedding scale bit
for bit, teacher-forced prefill and decode logits at positions past the
window (the chunked-attention path with its window block skip included,
``decode_window_slice`` both ways), the engine's token streams in the
monolithic, chunked (prefix cache) and speculative paths, one f32 head
shared by a router's replicas over a tied tree, and the draft proposer's
tied head.

Random weights make flat greedy streams (the reference emits one token
over and over on these configs), so equal streams prove little alone: the
logits are compared step by step. Tolerances: hidden states 1e-5, logits
1e-4 (f32 sums in another order), integers bit for bit."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import spec as ref_spec  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.configs import gemma2_27b as ref_gemma2_27b  # noqa: E402
from repro.configs import gemma3_1b as ref_gemma3_1b  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import SpecConfig as RefSpecConfig  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro.pool.cache import PrefixKVCache as RefPrefixKVCache  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import spec  # noqa: E402
from repro_torch.configs import SpecConfig, gemma2_27b, gemma3_1b  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import scale_embeddings  # noqa: E402
from repro_torch.models.layers import with_f32_head  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.models.transformer import RunFlags, segment_plan  # noqa: E402,E501
from repro_torch.pool.cache import PrefixKVCache  # noqa: E402
from repro_torch.serving import Engine, Router  # noqa: E402

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
MODULES = {"gemma2-27b": (gemma2_27b, ref_gemma2_27b),
           "gemma3-1b": (gemma3_1b, ref_gemma3_1b)}
# the emulated operating point: StoreStats and the clock do not depend on
# host step times
ENGINE_KW = dict(pool="CXL", max_batch=2, max_len=64, prompt_bucket=8,
                 emulate_step_s=5e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def bridged():
    """Per name: (port cfg, ref cfg, ref params, port params bridged)."""
    out = {}
    for name, (mod, ref_mod) in MODULES.items():
        cfg, rcfg = mod.reduced(), ref_mod.reduced()
        rparams = ref_model.init_params(rcfg, 0)
        out[name] = (cfg, rcfg, rparams,
                     from_jax(jax.tree.map(np.asarray, rparams), cfg,
                              device="cpu"))
    return out


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_configs_identical(name, size):
    """Field by field, with the same parameter count, Engram layers and
    segment plan (gemma2: prefix 1 and period 2 tails; gemma3: a prefix-3
    period-6 tail), and its parameter defs build."""
    mod, ref_mod = MODULES[name]
    cfg, rcfg = getattr(mod, size)(), getattr(ref_mod, size)()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.engram_layers() == rcfg.engram_layers()
    assert [dataclasses.astuple(s) for s in segment_plan(cfg)] == \
        [dataclasses.astuple(s) for s in ref_transformer.segment_plan(rcfg)]
    port_model.model_defs(cfg)
    if size == "full":
        assert configs.get_config(name) == cfg


def test_shapes_match_reference():
    """``SHAPES``, and ``applicable_shapes``/``skipped_shapes`` for every
    config the port registers."""
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}
    for name in configs.list_archs():
        cfg, rcfg = configs.get_config(name), ref_get_config(name)
        assert configs.applicable_shapes(cfg) == \
            ref_base.applicable_shapes(rcfg), name
        assert configs.skipped_shapes(cfg) == ref_base.skipped_shapes(rcfg)
    assert {"gemma2-27b", "gemma3-1b"} <= set(configs.list_archs())


# ---------------------------------------------------------------- embedding

def test_scaled_embedding_bf16_bit_equal():
    """The reference multiplies bf16 embeddings by a weakly typed Python
    float, which JAX rounds to bf16 first (sqrt(4608) = 67.88 -> 68.0):
    the port's scale equals it bit for bit, where an unrounded factor
    would not."""
    rcfg = ref_get_config("gemma2-27b")
    d = rcfg.d_model
    rng = np.random.RandomState(0)
    table = rng.randn(32, d).astype(np.float32)
    tokens = rng.randint(0, 32, size=(2, 16))
    want = ref_model.embed_inputs(
        rcfg, {"embed": {"w": jnp.asarray(table, jnp.bfloat16)}},
        {"tokens": jnp.asarray(tokens, jnp.int32)})
    want = torch.from_numpy(np.asarray(want).view(np.uint16).astype(np.int32))
    h = _t(table).to(torch.bfloat16)[_t(tokens)]
    got = scale_embeddings(h, d)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16).int() & 0xFFFF, want)
    naive = (h * math.sqrt(d)).view(torch.int16).int() & 0xFFFF
    assert not torch.equal(naive, want)


# ------------------------------------------------------ prefill and decode

def _ref_layer_caches(cfg, rcaches):
    """The reference's per-segment ``prefix``/``stack`` caches as one
    {k, v} dict per layer, in the port's layer order."""
    out = []
    for seg, sc in zip(segment_plan(cfg), rcaches):
        layers = [dict(c) for c in sc["prefix"]]
        for r in range(seg.n_periods):
            for pos in range(seg.period):
                layers.append({n: np.asarray(a)[r]
                               for n, a in sc["stack"][pos].items()})
        out.append(layers)
    return out


def _batch(cfg, seed, S=40, lens=(40, 29)):
    rng = np.random.RandomState(seed)
    return rng.randint(1, cfg.vocab_size, size=(len(lens), S)), \
        np.array(lens)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_prefill_past_window(bridged, name, chunked):
    """40- and 29-token prompts (window 16): final hidden states, the last
    logits and every layer's k/v against the reference's, dense or, with
    ``chunk_threshold`` below the prompt and 8-token chunks, through
    ``_chunk_attn``, whose local layers skip the KV blocks wholly before
    the window (3 per layer per call at these sizes)."""
    cfg, rcfg, rparams, params = bridged[name]
    fl = dict(chunk_threshold=8, q_chunk=8, kv_chunk=8) if chunked else {}
    toks, lens = _batch(cfg, 1)
    rbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              "lengths": jnp.asarray(lens, jnp.int32)}
    batch = {"tokens": _t(toks), "lengths": _t(lens)}
    rh = jax.jit(lambda p, b: ref_model.forward(
        rcfg, RefFlags(**fl), p, b, "prefill")[0])(rparams, rbatch)
    port_attn._chunk_attn.window_skipped = 0
    h, _ = port_model.forward(cfg, RunFlags(**fl), params, batch, "prefill")
    n_local = sum(k == "local" for k in cfg.attn_kinds)
    assert port_attn._chunk_attn.window_skipped == (3 * n_local if chunked
                                                    else 0)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **F32)
    want, rstate = jax.jit(ref_model.build_prefill_step(
        rcfg, RefFlags(**fl), max_len=48))(rparams, rbatch)
    got, state = port_model.build_prefill_step(cfg, RunFlags(**fl),
                                               max_len=48)(params, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    for seg, rseg in zip(state["caches"],
                         _ref_layer_caches(cfg, rstate["caches"])):
        for kv, rkv in zip(seg, rseg):
            for n in ("k", "v"):
                np.testing.assert_allclose(kv[n].numpy(),
                                           np.asarray(rkv[n]), **F32)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_decode_past_window_both_ways(bridged, name):
    """Teacher-forced decode from 20- and 13-token prefixes, 28 steps (to
    position 47, past the 16-token window): each step's logits against the
    reference's with the same ``decode_window_slice``, and the port's
    sliced run against its masked one."""
    cfg, rcfg, rparams, params = bridged[name]
    toks, lens = _batch(cfg, 2, S=20, lens=(20, 13))
    forced = np.random.RandomState(3).randint(1, cfg.vocab_size,
                                              size=(28, 2))
    rpre = jax.jit(ref_model.build_prefill_step(rcfg, RefFlags(),
                                                max_len=48))
    runs = {}
    for ws in (False, True):
        rdec = jax.jit(ref_model.build_decode_step(
            rcfg, RefFlags(decode_window_slice=ws)))
        dec = port_model.build_decode_step(
            cfg, RunFlags(decode_window_slice=ws))
        _, rs = rpre(rparams, {"tokens": jnp.asarray(toks, jnp.int32),
                               "lengths": jnp.asarray(lens, jnp.int32)})
        _, s = port_model.build_prefill_step(cfg, RunFlags(), max_len=48)(
            params, {"tokens": _t(toks), "lengths": _t(lens)})
        logits = []
        for tok in forced:
            want, rs = rdec(rparams, rs, jnp.asarray(tok, jnp.int32))
            got, s = dec(params, s, _t(tok))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **LOGITS)
            logits.append(got)
        np.testing.assert_array_equal(s["positions"].numpy(),
                                      np.asarray(rs["positions"]))
        runs[ws] = torch.stack(logits)
    torch.testing.assert_close(runs[True], runs[False], **LOGITS)


# ------------------------------------------------------------------ engines

def _prompts(cfg, seed, lens):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
            for n in lens]


def _head_prompts(cfg):
    """A shared 16-token head (two 8-token prefix blocks) and three tails:
    every prompt runs past the window."""
    head = _prompts(cfg, 4, [16])[0]
    return [head + p for p in _prompts(cfg, 5, [3, 7, 12])]


def _run(engine, prompts, max_new, one_at_a_time=False):
    if one_at_a_time:
        out = []
        for p in prompts:
            rid = engine.submit(list(p), max_new=max_new)
            engine.run()
            out.append(engine.done[rid].out)
        return out
    rids = [engine.submit(list(p), max_new=max_new) for p in prompts]
    engine.run()
    return [engine.done[r].out for r in rids]


@pytest.fixture(scope="module")
def engine_runs(bridged):
    """Each (config, mode) run once on both engines: {(name, mode):
    (reference engine, port engine, reference streams, port streams)},
    filled on first use (the reference's runs are the slow part)."""
    cache = {}

    def get(name, mode):
        if (name, mode) in cache:
            return cache[(name, mode)]
        cfg, rcfg, rparams, params = bridged[name]
        kw, rkw, alone = dict(ENGINE_KW), dict(ENGINE_KW), False
        prompts = _prompts(cfg, 6, [18, 23, 30])
        if mode == "chunked":
            prompts, alone = _head_prompts(cfg), True
            kw.update(prefill_chunk=8, prefix_cache=PrefixKVCache(64 << 20,
                                                                  8))
            rkw.update(prefill_chunk=8,
                       prefix_cache=RefPrefixKVCache(64 << 20, 8))
        elif mode == "spec":
            plain = get(name, "monolithic")[3]
            script = [p + o for p, o in zip(prompts, plain)]
            kw.update(spec=SpecConfig(), proposer=spec.ScriptedProposer(
                script))
            rkw.update(spec=RefSpecConfig(),
                       proposer=ref_spec.ScriptedProposer(script))
        reng = RefEngine(rcfg, params=rparams, **rkw)
        eng = Engine(cfg, params=params, device="cpu", **kw)
        cache[(name, mode)] = (reng, eng, _run(reng, prompts, 12, alone),
                               _run(eng, prompts, 12, alone))
        return cache[(name, mode)]

    return get


@pytest.mark.parametrize("mode", ["monolithic", "chunked", "spec"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_engine_streams_match_reference(engine_runs, name, mode):
    """Prompts of 18 to 30 tokens and 12 new ones, pool CXL at the
    emulated operating point: the reference Engine's streams bit for bit,
    StoreStats field by field and the virtual clock;
    chunked admission restores the shared head from the prefix cache;
    the scripted speculation accepts every draft and emits the
    monolithic streams."""
    reng, eng, want, got = engine_runs(name, mode)
    assert got == want
    assert all(len(s) == 12 for s in got)
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(reng.store.stats())
    assert eng.clock.stats() == reng.clock.stats()
    if mode == "chunked":
        assert eng.stats.prefix_hit_blocks == \
            reng.stats.prefix_hit_blocks > 0
    if mode == "spec":
        assert got == engine_runs(name, "monolithic")[3]
        assert eng.stats.accepted_tokens == reng.stats.accepted_tokens \
            == eng.stats.proposed_tokens > 0


def test_router_replicas_share_one_tied_f32_head(bridged):
    """A tied tree has no ``head``: its f32 head is the transposed
    embedding, held in ``embed["w32"]``, made once by the router and
    shared by every replica; with an f32 embedding it is a view of the
    embedding itself. Both replicas serve the plain engine's streams."""
    cfg, _, _, params = bridged["gemma3-1b"]
    assert "head" not in params
    kw = dict(replicas=2, pool="CXL", device="cpu", max_batch=2, max_len=64,
              prompt_bucket=8)
    router = Router(cfg, params=params, **kw)
    embeds = [rt.engine.params["embed"] for rt in router.replicas]
    assert embeds[0]["w32"] is embeds[1]["w32"]
    assert embeds[0]["w32"].shape == (cfg.d_model, cfg.vocab_size)
    assert embeds[0]["w32"].data_ptr() == params["embed"]["w"].data_ptr()
    prompts = _prompts(cfg, 7, [18, 21])
    handles = [router.submit(p, max_new=6) for p in prompts]
    router.drain()
    plain = Engine(cfg, params=params, device="cpu", **ENGINE_KW)
    assert [h.tokens for h in handles] == _run(plain, prompts, 6)
    bf16 = dict(params, embed={"w": params["embed"]["w"].bfloat16()})
    router = Router(cfg, params=bf16, **kw)
    w32 = [rt.engine.params["embed"]["w32"] for rt in router.replicas]
    assert w32[0] is w32[1] and w32[0].dtype == torch.float32
    assert "w32" not in bf16["embed"]            # the caller's tree as given
    prepared = with_f32_head(bf16)
    assert with_f32_head(prepared) is prepared


@pytest.mark.parametrize("name", sorted(MODULES))
def test_draft_proposer_carries_tied_head(name):
    """The draft model's shrunk config keeps the first two layers' kinds
    and the tied, scaled embedding; on the reference draft's bridged
    weights its tree has no ``head``, its f32 head is the transposed
    embedding, and its proposals are the reference's bit for bit."""
    mod, ref_mod = MODULES[name]
    cfg, rcfg = mod.reduced(), ref_mod.reduced()
    sp, rsp = SpecConfig(max_draft=3, draft_layers=2), \
        RefSpecConfig(max_draft=3, draft_layers=2)
    dcfg = spec.draft_config(cfg, sp)
    assert dcfg.attn_kinds == cfg.attn_kinds[:2] and dcfg.tie_embeddings
    ref = ref_spec.DraftModelProposer(rcfg, rsp, seed=1)
    params = from_jax(jax.tree.map(np.asarray, ref.params), dcfg,
                      device="cpu")
    port = spec.DraftModelProposer(cfg, sp, params=params, device="cpu")
    assert "head" not in port.params
    assert port.params["embed"]["w32"].shape == (cfg.d_model,
                                                 cfg.vocab_size)
    for ctx in _prompts(cfg, 8, [5, 23]):
        assert port.propose(0, ctx, 3) == ref.propose(0, ctx, 3)
