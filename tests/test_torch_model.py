"""PyTorch port vs the JAX reference: configs, layers, both attention paths,
prefill/decode logits and greedy streams, on the tiny serving config and
the reduced engram-27b, gemma2-27b and gemma3-1b configs, in float32.

Parameters come from the reference's ``init_params`` (``jax.random`` cannot
be reproduced in torch) bridged with ``from_jax``; other inputs are drawn
with numpy. Tolerances: f32 results that differ only in summation order
match to 1e-5; logits after several layers to 1e-4."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_7b as ref_deepseek_7b  # noqa: E402
from repro.configs import engram_27b as ref_engram_27b  # noqa: E402
from repro.configs import gemma2_27b as ref_gemma2_27b  # noqa: E402
from repro.configs import gemma3_1b as ref_gemma3_1b  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import engram as ref_engram  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro_torch.configs import deepseek_7b, engram_27b  # noqa: E402
from repro_torch.configs import gemma2_27b, gemma3_1b  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engram as port_engram  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.params import from_jax, init_params  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.transformer import RunFlags  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)


def _tiny(mod):
    """tests/test_serving.py's tiny config: 3 layers, Engram at layer 1."""
    cfg = mod.reduced()
    return dataclasses.replace(cfg, n_layers=3, layer_types=("attn",) * 3,
                               attn_kinds=("global",) * 3,
                               ffn_types=("dense",) * 3,
                               engram=dataclasses.replace(cfg.engram,
                                                          layers=(1,)))


CONFIGS = {
    "tiny": (_tiny(deepseek_7b), _tiny(ref_deepseek_7b)),
    "engram-27b-reduced": (engram_27b.reduced(), ref_engram_27b.reduced()),
    "gemma2-27b-reduced": (gemma2_27b.reduced(), ref_gemma2_27b.reduced()),
    "gemma3-1b-reduced": (gemma3_1b.reduced(), ref_gemma3_1b.reduced()),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def bridged(request):
    """(port cfg, ref cfg, ref params, port params bridged from them)."""
    cfg, rcfg = CONFIGS[request.param]
    rparams = ref_model.init_params(rcfg, 0)
    params = from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, rcfg, rparams, params


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("name", ["engram-27b", "deepseek-7b", "engram-40b",
                                  "deepseek-coder-33b", "gemma2-27b",
                                  "gemma3-1b"])
def test_configs_identical(name):
    cfg, rcfg = get_config(name), ref_get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.engram_layers() == rcfg.engram_layers()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reduced_configs_identical(name):
    cfg, rcfg = CONFIGS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)


def test_padded_vocab_matches():
    e, re_ = get_config("engram-27b").engram, ref_get_config(
        "engram-27b").engram
    assert port_engram.padded_vocab(e) == ref_engram.padded_vocab(re_) \
        == 2_265_088


# ------------------------------------------------------------------- layers

def test_rmsnorm_softcap_head():
    rng = np.random.RandomState(0)
    x, scale = rng.randn(3, 5, 24).astype(np.float32), rng.randn(24)
    want = ref_layers.rmsnorm({"scale": jnp.asarray(scale, jnp.float32)},
                              jnp.asarray(x), 1e-6)
    got = port_layers.rmsnorm({"scale": _t(scale).float()}, _t(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(
        port_layers.softcap(_t(x) * 40, 30.0).numpy(),
        np.asarray(ref_layers.softcap(jnp.asarray(x) * 40, 30.0)), **F32)
    w = rng.randn(24, 50).astype(np.float32)
    want = ref_layers.head_logits({"w": jnp.asarray(w)}, jnp.asarray(x[:, 0]))
    got = port_layers.head_logits({"w": _t(w)}, _t(x[:, 0]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the f32 head copy made once gives the same logits for a bf16 head
    wb = _t(w).to(torch.bfloat16)
    held = port_layers.with_f32_head({"head": {"w": wb}})["head"]
    assert held["w32"].dtype == torch.float32
    np.testing.assert_array_equal(
        port_layers.head_logits(held, _t(x[:, 0])).numpy(),
        port_layers.head_logits({"w": wb}, _t(x[:, 0])).numpy())


@pytest.mark.parametrize("theta", [10_000.0, 500.0])
def test_apply_rope_half_split(theta):
    """F4: the half-split rotation, for prefill (S,) and decode (B, 1)
    position layouts."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 3, 16).astype(np.float32)
    pos = np.arange(6) + 5
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = port_layers.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    xd = x[:, :1]
    pd = np.array([[3], [250]])
    want = ref_layers.apply_rope(jnp.asarray(xd), jnp.asarray(pd), theta)
    got = port_layers.apply_rope(_t(xd), _t(pd), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = np.random.RandomState(2)
    p = {k: rng.randn(*s).astype(np.float32) / 4 for k, s in
         (("gate", (16, 40)), ("up", (16, 40)), ("down", (40, 16)))}
    x = rng.randn(2, 3, 16).astype(np.float32)
    want = ref_layers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), act)
    got = port_layers.mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---------------------------------------------------------------- attention

def _mixer(bridged):
    cfg, rcfg, rparams, params = bridged
    return (params["segments"][0][0]["mixer"],
            jax.tree.map(lambda a: a[0] if a.ndim == 3 else a,
                         rparams["segments"][0]["stack"][0]["mixer"])
            if rparams["segments"][0]["stack"] else
            rparams["segments"][0]["prefix"][0]["mixer"])


def test_prefill_attention(bridged):
    cfg, rcfg, _, _ = bridged
    pm, rm = _mixer(bridged)
    np.testing.assert_array_equal(pm["wq"].numpy(), np.asarray(rm["wq"]))
    x = np.random.RandomState(4).randn(2, 7, cfg.d_model).astype(np.float32)
    pos = np.arange(7)
    want, wkv = ref_attn.attention(rcfg, rm, jnp.asarray(x),
                                   jnp.asarray(pos), "global")
    got, kv = port_attn.attention(cfg, pm, _t(x), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(kv["k"].numpy(), np.asarray(wkv["k"]), **F32)
    # past chunk_threshold: the chunked path (ragged 4-token chunks)
    want, _ = ref_attn.attention(rcfg, rm, jnp.asarray(x), jnp.asarray(pos),
                                 "global", chunk_threshold=4, q_chunk=4,
                                 kv_chunk=4)
    got, _ = port_attn.attention(cfg, pm, _t(x), _t(pos), chunk_threshold=4,
                                 q_chunk=4, kv_chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_attention_per_slot_positions(bridged):
    cfg, rcfg, _, _ = bridged
    pm, rm = _mixer(bridged)
    rng = np.random.RandomState(5)
    B, Smax = 3, 12
    cache = {n: rng.randn(B, Smax, cfg.n_kv_heads, cfg.head_dim)
             .astype(np.float32) for n in ("k", "v")}
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    pos = np.array([0, 5, Smax + 3])          # the last write clamps
    want, wc = ref_attn.decode_attention(
        rcfg, rm, jnp.asarray(x), {n: jnp.asarray(v) for n, v in
                                   cache.items()}, jnp.asarray(pos), "global")
    pc = {n: _t(v.copy()) for n, v in cache.items()}
    got, gc = port_attn.decode_attention(cfg, pm, _t(x), pc, _t(pos))
    assert gc["k"] is pc["k"]                 # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for n in ("k", "v"):
        np.testing.assert_allclose(gc[n].numpy(), np.asarray(wc[n]), **F32)


def test_fully_masked_row_is_uniform_not_nan():
    """F5: NEG_INF = -2**30, so a row with nothing valid averages v."""
    cfg = engram_27b.reduced()
    rng = np.random.RandomState(6)
    q = rng.randn(2, 1, cfg.n_heads, cfg.head_dim).astype(np.float32)
    k = rng.randn(2, 9, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    v = rng.randn(2, 9, cfg.n_kv_heads, cfg.head_dim).astype(np.float32)
    mask = np.zeros((2, 1, 9), bool)
    mask[0, 0, :4] = True                     # row 1 fully masked
    got = port_attn._sdpa(cfg, _t(q), _t(k), _t(v), _t(mask)).numpy()
    want = np.asarray(ref_attn._sdpa(cfg, jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(mask)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F32)
    g = cfg.n_heads // cfg.n_kv_heads
    uniform = np.repeat(v[1].mean(axis=0), g, axis=0)
    np.testing.assert_allclose(got[1, 0], uniform, **F32)


# ------------------------------------------------------------ whole model

def _ref_steps(rcfg, max_len):
    return (jax.jit(ref_model.build_prefill_step(rcfg, RefFlags(),
                                                 max_len=max_len)),
            jax.jit(ref_model.build_decode_step(rcfg, RefFlags())))


def test_prefill_and_decode_logits(bridged):
    cfg, rcfg, rparams, params = bridged
    rng = np.random.RandomState(7)
    toks = rng.randint(1, cfg.vocab_size, size=(3, 8))
    lens = np.array([8, 3, 5])
    rpre, rdec = _ref_steps(rcfg, 24)
    want, rstate = rpre(rparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                  "lengths": jnp.asarray(lens, jnp.int32)})
    pre = port_model.build_prefill_step(cfg, RunFlags(), max_len=24)
    dec = port_model.build_decode_step(cfg, RunFlags())
    got, state = pre(params, {"tokens": _t(toks), "lengths": _t(lens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_array_equal(state["last_tokens"].numpy(),
                                  np.asarray(rstate["last_tokens"]))
    for step in range(3):
        tok = rng.randint(1, cfg.vocab_size, size=(3,))
        want, rstate = rdec(rparams, rstate, jnp.asarray(tok, jnp.int32))
        got, state = dec(params, state, _t(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_array_equal(state["positions"].numpy(),
                                  np.asarray(rstate["positions"]))


def test_greedy_stream_16_tokens(bridged):
    cfg, rcfg, rparams, params = bridged
    prompt = np.array([[5, 17, 42, 7, 3, 11]])
    rpre, rdec = _ref_steps(rcfg, 32)
    logits, rstate = rpre(rparams, {"tokens": jnp.asarray(prompt, jnp.int32)})
    ref_stream = []
    for _ in range(16):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        ref_stream.append(int(tok[0]))
        logits, rstate = rdec(rparams, rstate, tok)
    pre = port_model.build_prefill_step(cfg, RunFlags(), max_len=32)
    dec = port_model.build_decode_step(cfg, RunFlags())
    logits, state = pre(params, {"tokens": _t(prompt)})
    stream = []
    for _ in range(16):
        tok = torch.argmax(logits, dim=-1)
        stream.append(int(tok[0]))
        logits, state = dec(params, state, tok)
    assert stream == ref_stream


def test_external_rows_and_strategies(bridged):
    """Decode with rows gathered outside (the engine's prefetch path)
    equals decode that gathers itself; pooled/tp reduce to local without a
    mesh; pooled_host (a CPU table: K1's plain version) gathers the same
    rows."""
    cfg, _, _, params = bridged
    e = cfg.engram
    toks = torch.tensor([[3, 9, 4], [8, 1, 2]])
    pre = port_model.build_prefill_step(cfg, RunFlags(), max_len=16)
    _, s1 = pre(params, {"tokens": toks})
    _, s2 = pre(params, {"tokens": toks})
    tok = torch.tensor([5, 6])
    idx = port_model.decode_engram_indices(e, s1["last_tokens"], tok)
    tables = params["engram"]["layers"][0]["tables"]
    local = port_engram.retrieve(e, tables, idx, "local")
    for strategy in ("pooled", "tp", "local_kernel"):
        np.testing.assert_array_equal(
            port_engram.retrieve(e, tables, idx, strategy).numpy(),
            local.numpy())
    np.testing.assert_array_equal(
        port_engram.retrieve(e, tables, idx, "pooled_host").numpy(),
        local.numpy())
    rows = [port_engram.retrieve(e, layer["tables"], idx)
            for layer in params["engram"]["layers"]]
    a, _ = port_model.build_decode_step(cfg, RunFlags())(params, s1, tok)
    b, _ = port_model.build_decode_step(cfg, RunFlags(), external_rows=True)(
        params, s2, tok, rows)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# --------------------------------------------------------------- params

def test_init_params_mirrors_reference_tree(bridged):
    """Same tree and shapes as the bridged reference params, and each
    leaf drawn from the reference's distribution (1/sqrt of the
    reference leaf's first dim, stacked leaves included)."""
    cfg, _, _, bridged_params = bridged
    mine = init_params(cfg, seed=3, device="cpu")
    shapes = lambda p: tree_map(lambda t: (tuple(t.shape), t.dtype), p)  # noqa
    assert shapes(mine) == shapes(bridged_params)
    ref_leaves = dict(_paths(bridged_params))
    for path, a in _paths(mine):
        b = ref_leaves[path]
        if a.numel() >= 2000:
            ratio = a.float().std().item() / b.float().std().item()
            assert abs(ratio - 1.0) < 0.1, ratio
    again = dict(_paths(init_params(cfg, seed=3, device="cpu")))
    assert all(torch.equal(x, again[p]) for p, x in _paths(mine))


def test_unported_config_features_raise():
    """Encoder and frontend configs name their ROADMAP item (windows and
    qk-norms are ported: tests/test_torch_gemma.py; MLA and MoE:
    tests/test_torch_mla.py and tests/test_torch_moe.py; Mamba and xLSTM:
    tests/test_torch_mamba.py and tests/test_torch_xlstm.py)."""
    cfg = engram_27b.reduced()
    for bad in (dict(is_encoder=True, frontend="audio"),
                dict(frontend="vision")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_model.model_defs(dataclasses.replace(cfg, **bad))


def _paths(tree, prefix=()):
    """(path, leaf) pairs of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree
