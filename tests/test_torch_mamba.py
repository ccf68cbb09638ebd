"""PyTorch port vs the JAX reference: the Mamba mixer and the
jamba-1.5-large-398b configs on the CPU, in float32.

``mamba_forward`` prefill from zero state, decode and a multi-token
continuation from a random state (the output and both cache leaves),
``init_mamba_cache``, the Mamba leaves' definitions and initialisation
(``zeros`` among them), ``from_jax`` on the leaves the reference stacks,
and the reduced jamba model: prefill and decode logits and caches against
the reference's, and prefill then decode against one full pass (the twin
of tests/test_decode_consistency.py).

Layer parameters and inputs are seeded numpy arrays (normal over
sqrt(fan-in), nonzero where the reference initialises zeros, so every
term is exercised); model parameters come from the reference's
``init_params`` bridged with ``from_jax``. Tolerances: one layer's outputs
and caches 1e-5, logits after the stack 1e-4, and the stack's caches 1e-4
of each leaf's largest magnitude."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import jamba_1_5_large_398b as ref_jamba  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.params import is_def  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import jamba_1_5_large_398b as jamba  # noqa: E402
from repro_torch.models import mamba as port_mamba  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import head_logits  # noqa: E402
from repro_torch.models.params import (from_jax, init_params,  # noqa: E402
                                       pd, tree_init, tree_leaves, tree_map)
from repro_torch.models.transformer import RunFlags, segment_plan  # noqa: E402,E501

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def bridged():
    """(port cfg, ref cfg, ref params, port params bridged) of reduced
    jamba."""
    cfg, rcfg = jamba.reduced(), ref_jamba.reduced()
    rparams = ref_model.init_params(rcfg, 0)
    return cfg, rcfg, rparams, from_jax(jax.tree.map(np.asarray, rparams),
                                        cfg, device="cpu")


@pytest.fixture(scope="module")
def layer():
    """One Mamba layer of reduced jamba with seeded numpy leaves: (cfg, ref
    cfg, ref params, port params)."""
    cfg, rcfg = jamba.reduced(), ref_jamba.reduced()
    rng = np.random.RandomState(11)
    leaves = jax.tree.map(
        lambda d: (rng.randn(*d.shape) / np.sqrt(d.shape[0]))
        .astype(np.float32),
        ref_mamba.mamba_defs(rcfg, "float32"), is_leaf=is_def)
    return (cfg, rcfg, jax.tree.map(jnp.asarray, leaves),
            tree_map(_t, leaves))


def _cache(cfg, rng, B):
    di, mc = cfg.mamba.d_inner(cfg.d_model), cfg.mamba
    return {"conv": rng.randn(B, mc.d_conv - 1, di).astype(np.float32),
            "ssm": rng.randn(B, di, mc.d_state).astype(np.float32)}


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("size", ["full", "reduced"])
def test_configs_identical(size):
    """Field by field, with the reference's parameter counts, Engram
    layers and segment plan, and its parameter defs build."""
    cfg, rcfg = getattr(jamba, size)(), getattr(ref_jamba, size)()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert cfg.engram_layers() == rcfg.engram_layers()
    assert [dataclasses.astuple(s) for s in segment_plan(cfg)] == \
        [dataclasses.astuple(s) for s in ref_transformer.segment_plan(rcfg)]
    port_model.model_defs(cfg)
    if size == "full":
        assert configs.get_config("jamba-1.5-large-398b") == cfg


@pytest.mark.parametrize("d", [64, 1000, 4096, 8192])
def test_dt_rank_and_defs_match_reference(d):
    """``dt_rank`` and each Mamba leaf's shape, dtype and initialiser at
    the reference's widths."""
    assert port_mamba.dt_rank(d) == ref_mamba.dt_rank(d)
    cfg = dataclasses.replace(jamba.full(), d_model=d)
    rcfg = dataclasses.replace(ref_jamba.full(), d_model=d)
    mine = port_mamba.mamba_defs(cfg, "bfloat16")
    want = ref_mamba.mamba_defs(rcfg, "bfloat16")
    assert {k: (v.shape, v.dtype, v.init) for k, v in mine.items()} == \
        {k: (v.shape, v.dtype, v.init) for k, v in want.items()}


# -------------------------------------------------------------- the layer

@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("from_state", [False, True])
def test_mamba_forward_matches_reference(layer, S, from_state):
    """Prefill from zero state (no cache) and a decode step or a 9-token
    continuation from a random state: the output, the conv state (the
    last K-1 inputs) and the SSM state."""
    cfg, rcfg, rparams, params = layer
    rng = np.random.RandomState(S + 10 * from_state)
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    cache = _cache(cfg, rng, 2) if from_state else None
    want, wc = ref_mamba.mamba_forward(
        rcfg, rparams, jnp.asarray(x),
        None if cache is None else jax.tree.map(jnp.asarray, cache))
    got, gc = port_mamba.mamba_forward(
        cfg, params, _t(x), None if cache is None else tree_map(_t, cache))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert set(gc) == set(wc) == {"conv", "ssm"}
    for n in gc:
        assert gc[n].dtype == torch.float32
        np.testing.assert_allclose(_np(gc[n]), np.asarray(wc[n]), **F32)


def test_decode_steps_equal_one_prefill(layer):
    """Twelve ``mamba_decode`` steps from zero state end where one
    12-token prefill ends: each step's output is the prefill's at that
    position, and the caches agree."""
    cfg, _, _, params = layer
    x = _t(np.random.RandomState(3).randn(2, 12, cfg.d_model)
           .astype(np.float32))
    full, fc = port_mamba.mamba_forward(cfg, params, x)
    cache = port_mamba.init_mamba_cache(cfg, 2, torch.float32, "cpu")
    for t in range(12):
        out, cache = port_mamba.mamba_decode(cfg, params, x[:, t:t + 1],
                                             cache)
        torch.testing.assert_close(out[:, 0], full[:, t], **F32)
    for n in fc:
        torch.testing.assert_close(cache[n], fc[n], **F32)


def test_init_mamba_cache_matches_reference():
    cfg, rcfg = jamba.reduced(), ref_jamba.reduced()
    mine = port_mamba.init_mamba_cache(cfg, 3, torch.float32, "cpu")
    want = ref_mamba.init_mamba_cache(rcfg, 3, jnp.float32)
    assert {n: (tuple(t.shape), str(t.dtype).split(".")[1])
            for n, t in mine.items()} == \
        {n: (a.shape, str(a.dtype)) for n, a in want.items()}


# ------------------------------------------------------------------ params

def test_zeros_init_keeps_the_draw_order():
    """A ``zeros`` leaf draws nothing: the normal leaves after it get the
    bytes they get without it, and ``ones``/``zeros`` fill their value."""
    defs = {"a": pd(5, 7), "z": pd(6, init="zeros"), "o": pd(3, init="ones"),
            "b": pd(4, 9)}
    got = tree_init(defs, 5, "cpu")
    plain = tree_init({"a": pd(5, 7), "b": pd(4, 9)}, 5, "cpu")
    assert torch.equal(got["a"], plain["a"])
    assert torch.equal(got["b"], plain["b"])
    assert not got["z"].any() and got["o"].eq(1).all()


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def test_init_params_mirrors_reference(bridged):
    """The port's seeded tree has the bridged tree's leaves, shapes and
    dtypes; the zeros leaves (``conv_b``, ``dt_bias``, ``A_log``) and the
    ones leaves (``D``) equal the reference's, and every Mamba matrix of
    1000 elements or more has the reference's std within 0.1 (fan-in: the
    leading dimension, ``n_periods`` for a stacked layer)."""
    cfg, _, _, bparams = bridged
    mine = dict(_paths(init_params(cfg, seed=3, device="cpu")))
    ref = dict(_paths(bparams))
    assert {p: (tuple(t.shape), t.dtype) for p, t in mine.items()} == \
        {p: (tuple(t.shape), t.dtype) for p, t in ref.items()}
    checked = set()
    for path, a in mine.items():
        if path[0] != "segments" or path[3] != "mixer" or \
                cfg.layer_types[_layer(cfg, path)] != "mamba":
            continue
        if path[4] in ("conv_b", "dt_bias", "A_log", "D"):
            assert torch.equal(a, ref[path]), path
        elif a.numel() >= 1000:
            ratio = a.std().item() / ref[path].std().item()
            assert abs(ratio - 1.0) < 0.1, (path, ratio)
            checked.add(path[4])
    assert {"in_proj", "x_proj", "out_proj"} <= checked


def _layer(cfg, path):
    """The absolute layer of a ``segments`` path (segment, block)."""
    return segment_plan(cfg)[path[1]].layers[path[2]]


def test_from_jax_unstacks_recurrent_leaves(bridged):
    """Reduced jamba stacks layers 4 to 7 (period 2: mamba+moe,
    mamba+dense): each port block holds its own row of the reference's
    stacked Mamba leaves."""
    cfg, _, rparams, params = bridged
    seg = segment_plan(cfg)[2]
    assert (seg.layers, seg.period, seg.n_periods) == ((4, 5, 6, 7), 2, 2)
    stack = rparams["segments"][2]["stack"]
    for j, li in enumerate(seg.layers):
        r, pos = divmod(j, seg.period)
        for name in ("in_proj", "conv_w", "conv_b", "A_log", "D"):
            np.testing.assert_array_equal(
                _np(params["segments"][2][j]["mixer"][name]),
                np.asarray(stack[pos]["mixer"][name])[r], err_msg=str(li))
        assert ("moe" if li % 2 else "dense") == cfg.ffn_types[li]


# ------------------------------------------------------------------ models

def _ref_layer_caches(cfg, rcaches):
    """The reference's per-segment ``prefix``/``stack`` caches as one dict
    per layer, in the port's layer order."""
    out = []
    for seg, sc in zip(segment_plan(cfg), rcaches):
        layers = [dict(c) for c in sc["prefix"]]
        for r in range(seg.n_periods):
            for pos in range(seg.period):
                layers.append({n: np.asarray(a)[r]
                               for n, a in sc["stack"][pos].items()})
        out.append(layers)
    return out


def _close_to_scale(got, want, tol=1e-4):
    """``allclose`` at ``tol`` relative to the leaf's largest magnitude: the
    stacked layers' SSM states reach 2e5 (the reference draws their
    weights at 1/sqrt(n_periods)), and f32 sums in another order through
    the stack leave an error of that scale's order in every element."""
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_prefill_and_decode_logits_match_reference(bridged):
    """Prompts of 12 and 12 tokens, then 5 teacher-forced decode steps:
    every step's logits, each layer's cache (Mamba's conv and ssm, the
    attention layer's KV padded to 24; to 1e-4 of the leaf's largest
    magnitude) and the positions."""
    cfg, rcfg, rparams, params = bridged
    rng = np.random.RandomState(2)
    toks = rng.randint(1, cfg.vocab_size, size=(2, 12))
    want, rs = jax.jit(ref_model.build_prefill_step(rcfg, RefFlags(),
                                                    max_len=24))(
        rparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    got, s = port_model.build_prefill_step(cfg, RunFlags(), max_len=24)(
        params, {"tokens": _t(toks)})
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS)
    rdec = jax.jit(ref_model.build_decode_step(rcfg, RefFlags()))
    dec = port_model.build_decode_step(cfg, RunFlags())
    for tok in rng.randint(1, cfg.vocab_size, size=(5, 2)):
        want, rs = rdec(rparams, rs, jnp.asarray(tok, jnp.int32))
        got, s = dec(params, s, _t(tok))
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS)
    kinds = set()
    for seg, rseg in zip(s["caches"], _ref_layer_caches(cfg, rs["caches"])):
        for c, rc in zip(seg, rseg):
            assert set(c) == set(rc)
            kinds.add(tuple(sorted(c)))
            for n in c:
                assert tuple(c[n].shape) == np.shape(rc[n])
                _close_to_scale(_np(c[n]), np.asarray(rc[n]))
    assert kinds == {("conv", "ssm"), ("k", "v")}
    np.testing.assert_array_equal(_np(s["positions"]),
                                  np.asarray(rs["positions"]))


def test_prefill_then_decode_matches_full_forward(bridged):
    """tests/test_decode_consistency.py's check on reduced jamba: an
    8-token prefill, then 4 decode steps, give the logits of one 12-token
    pass at the same positions (the reference's full forward too)."""
    cfg, rcfg, rparams, params = bridged
    toks = np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 12))
    rh, _, _ = ref_model.forward(rcfg, RefFlags(), rparams,
                                 {"tokens": jnp.asarray(toks, jnp.int32)},
                                 "train")
    want = np.asarray(ref_model.head_logits(rparams["head"], rh))
    h, _ = port_model.forward(cfg, RunFlags(), params, {"tokens": _t(toks)},
                              "prefill")
    full = head_logits(params["head"], h)
    np.testing.assert_allclose(_np(full), want, **LOGITS)
    logits, state = port_model.build_prefill_step(cfg, RunFlags(),
                                                  max_len=16)(
        params, {"tokens": _t(toks[:, :8])})
    torch.testing.assert_close(logits, full[:, 7], **LOGITS)
    dec = port_model.build_decode_step(cfg, RunFlags())
    for t in range(8, 12):
        logits, state = dec(params, state, _t(toks[:, t]))
        torch.testing.assert_close(logits, full[:, t], **LOGITS)
    assert all(t.shape[0] == 2 for t in tree_leaves(state["caches"]))


def teacher_forced(prefill, decode, params, toks, forced, to_dev):
    """Logits of a 2-row prefill (16 and 11 tokens, chunked attention) and
    of 48 teacher-forced decode steps after it, as numpy arrays: the run
    chip_smoke.py's phase 6 compares card and CPU on."""
    logits, state = prefill(params, {"tokens": to_dev(toks),
                                     "lengths": to_dev(np.array([16, 11]))})
    out = [np.asarray(logits)]
    for tok in forced:
        logits, state = decode(params, state, to_dev(tok))
        out.append(np.asarray(logits))
    return out


def forced_runs(cfg, rcfg, rparams, params):
    """(port, reference) teacher-forced logits on chip_smoke.py's
    ``forced_logits`` inputs and flags."""
    rng = np.random.RandomState(7)
    toks = rng.randint(1, cfg.vocab_size, size=(2, 16))
    forced = rng.randint(1, cfg.vocab_size, size=(48, 2))
    kw = dict(chunk_threshold=8, q_chunk=8, kv_chunk=8)
    port = teacher_forced(
        port_model.build_prefill_step(cfg, RunFlags(**kw), max_len=64),
        port_model.build_decode_step(cfg, RunFlags(**kw)), params, toks,
        forced, _t)
    ref = teacher_forced(
        jax.jit(ref_model.build_prefill_step(rcfg, RefFlags(**kw),
                                             max_len=64)),
        jax.jit(ref_model.build_decode_step(rcfg, RefFlags(**kw))), rparams,
        toks, forced, lambda a: jnp.asarray(a, jnp.int32))
    return port, ref


def test_teacher_forced_logits_match_reference(bridged):
    """48 teacher-forced decode steps after a ragged prefill (the pad
    tokens of the 11-token row scanned, as the reference scans them):
    the port's logits within 0.5 % of the largest logit of the
    reference's (rtol 1e-3). The stacked layers' SSM states (up to 2e5)
    carry f32 rounding through the steps, so two f32 implementations
    part by more than the 1e-3 that holds one step. chip_smoke.py's
    phase 6 holds card against CPU on this run to the same share
    (``RECURRENT_FORCED_TOL``)."""
    port, ref = forced_runs(*bridged)
    top = max(np.abs(b).max() for b in ref)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=5e-3 * top)
