"""PyTorch port vs the JAX reference: the xLSTM mixers (mLSTM, sLSTM) and
the xlstm-125m configs on the CPU, in float32.

``mlstm_forward`` and ``slstm_forward`` prefill from zero state, decode
and a multi-token continuation from a random state (the output and every
cache leaf), ``init_xlstm_cache``, the leaves' definitions, ``from_jax``
on the layers the reference stacks, and the reduced xLSTM model (no FFN,
a tied head): prefill and decode logits and caches against the
reference's, and prefill then decode against one full pass (the twin of
tests/test_decode_consistency.py).

Layer parameters and inputs are seeded numpy arrays (normal over
sqrt(fan-in), nonzero where the reference initialises zeros); model
parameters come from the reference's ``init_params`` bridged with
``from_jax``. Tolerances: one layer's outputs and caches 1e-5; logits
after the stack 2e-3, tests/test_decode_consistency.py's (see ``LOGITS``),
and the stack's caches 1e-3 of each leaf's largest magnitude (mLSTM's C
reaches 940)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import xlstm_125m as ref_xlstm_cfg  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402
from repro.models.params import is_def  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import xlstm_125m  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models import transformer as port_transformer  # noqa: E402
from repro_torch.models import xlstm as port_xlstm  # noqa: E402
from repro_torch.models.layers import head_logits  # noqa: E402
from repro_torch.models.params import from_jax, tree_map  # noqa: E402
from repro_torch.models.transformer import RunFlags, segment_plan  # noqa: E402,E501
from test_torch_mamba import forced_runs  # noqa: E402

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
# tests/test_decode_consistency.py's tolerance: through 8 layers of
# max-stabilised exponential gates the reference's own jitted prefill and
# its eager full pass differ on the order of 1e-3 on these logits
# (|logit| <= 24)
LOGITS = dict(rtol=2e-3, atol=2e-3)
KINDS = {"mlstm": (port_xlstm.mlstm_defs, ref_xlstm.mlstm_defs,
                   port_xlstm.mlstm_forward, ref_xlstm.mlstm_forward),
         "slstm": (port_xlstm.slstm_defs, ref_xlstm.slstm_defs,
                   port_xlstm.slstm_forward, ref_xlstm.slstm_forward)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def bridged():
    """(port cfg, ref cfg, ref params, port params bridged) of reduced
    xLSTM."""
    cfg, rcfg = xlstm_125m.reduced(), ref_xlstm_cfg.reduced()
    rparams = ref_model.init_params(rcfg, 0)
    return cfg, rcfg, rparams, from_jax(jax.tree.map(np.asarray, rparams),
                                        cfg, device="cpu")


def _layer(kind):
    """One ``kind`` layer of reduced xLSTM with seeded numpy leaves: (cfg,
    ref cfg, ref params, port params)."""
    cfg, rcfg = xlstm_125m.reduced(), ref_xlstm_cfg.reduced()
    rng = np.random.RandomState(13)
    leaves = jax.tree.map(
        lambda d: (rng.randn(*d.shape) / np.sqrt(d.shape[0]))
        .astype(np.float32),
        KINDS[kind][1](rcfg, "float32"), is_leaf=is_def)
    return (cfg, rcfg, jax.tree.map(jnp.asarray, leaves),
            tree_map(_t, leaves))


def _random_cache(cfg, kind, rng, B):
    """A random state of ``init_xlstm_cache``'s shapes (positive ``n`` for
    the sLSTM normaliser, as a run leaves it)."""
    zero = port_xlstm.init_xlstm_cache(cfg, kind, B, torch.float32, "cpu")
    out = {n: rng.randn(*t.shape).astype(np.float32)
           for n, t in zero.items()}
    if kind == "slstm":
        out["n"] = np.abs(out["n"]) + 0.5
    return out


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("size", ["full", "reduced"])
def test_configs_identical(size):
    """Field by field, with the reference's parameter counts, Engram
    layers and segment plan, and its parameter defs build."""
    cfg, rcfg = getattr(xlstm_125m, size)(), getattr(ref_xlstm_cfg, size)()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.engram_layers() == rcfg.engram_layers()
    assert [dataclasses.astuple(s) for s in segment_plan(cfg)] == \
        [dataclasses.astuple(s) for s in ref_transformer.segment_plan(rcfg)]
    port_model.model_defs(cfg)
    if size == "full":
        assert configs.get_config("xlstm-125m") == cfg


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_defs_match_reference(kind):
    """Each leaf's shape, dtype and initialiser at xlstm-125m's widths,
    and a whole block's keys in the reference's order (no ``ln2``/``ffn``:
    the config's FFN type is ``none``)."""
    cfg, rcfg = xlstm_125m.full(), ref_xlstm_cfg.full()
    mine, want = KINDS[kind][0](cfg, "bfloat16"), KINDS[kind][1](rcfg,
                                                                "bfloat16")
    flat = lambda t: {k: (v.shape, v.dtype, v.init) for k, v in  # noqa: E731
                      t.items() if not isinstance(v, dict)}
    assert flat(mine) == flat(want)
    assert list(mine) == list(want)
    i = cfg.layer_types.index(kind)
    assert list(port_transformer.block_defs(cfg, i, "bfloat16")) == \
        list(ref_transformer.block_defs(rcfg, i, "bfloat16")) == \
        ["ln1", "mixer"]


# -------------------------------------------------------------- the layers

@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("from_state", [False, True])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forward_matches_reference(kind, S, from_state):
    """Prefill from zero state (no cache), and a decode step or a 9-token
    continuation from a random state: the output and every cache leaf
    (the conv state; mLSTM's C, n, m; sLSTM's c, n, h, m)."""
    cfg, rcfg, rparams, params = _layer(kind)
    rng = np.random.RandomState(S + 10 * from_state)
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    cache = _random_cache(cfg, kind, rng, 2) if from_state else None
    want, wc = KINDS[kind][3](
        rcfg, rparams, jnp.asarray(x),
        None if cache is None else jax.tree.map(jnp.asarray, cache))
    got, gc = KINDS[kind][2](
        cfg, params, _t(x), None if cache is None else tree_map(_t, cache))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert set(gc) == set(wc)
    for n in gc:
        assert gc[n].dtype == torch.float32
        np.testing.assert_allclose(_np(gc[n]), np.asarray(wc[n]), **F32,
                                   err_msg=n)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_steps_equal_one_prefill(kind):
    """Ten one-token steps from zero state end where one 10-token prefill
    ends: each step's output is the prefill's at that position, and every
    cache leaf agrees."""
    cfg, _, _, params = _layer(kind)
    fwd = KINDS[kind][2]
    x = _t(np.random.RandomState(3).randn(2, 10, cfg.d_model)
           .astype(np.float32))
    full, fc = fwd(cfg, params, x)
    cache = port_xlstm.init_xlstm_cache(cfg, kind, 2, torch.float32, "cpu")
    for t in range(10):
        out, cache = fwd(cfg, params, x[:, t:t + 1], cache)
        torch.testing.assert_close(out[:, 0], full[:, t], **F32)
    for n in fc:
        torch.testing.assert_close(cache[n], fc[n], **F32)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_init_xlstm_cache_matches_reference(kind):
    cfg, rcfg = xlstm_125m.full(), ref_xlstm_cfg.full()
    mine = port_xlstm.init_xlstm_cache(cfg, kind, 3, torch.bfloat16, "cpu")
    want = ref_xlstm.init_xlstm_cache(rcfg, kind, 3, jnp.bfloat16)
    assert {n: (tuple(t.shape), str(t.dtype).split(".")[1])
            for n, t in mine.items()} == \
        {n: (a.shape, str(a.dtype)) for n, a in want.items()}
    # the sLSTM cell leaves are separate tensors: slot writes go in place
    ptrs = [t.data_ptr() for t in mine.values()]
    assert len(set(ptrs)) == len(ptrs)


# ------------------------------------------------------------------ params

def test_from_jax_unstacks_recurrent_leaves(bridged):
    """Reduced xLSTM stacks layers 1 to 3 (period 1, all mLSTM): each port
    block holds its own row of the reference's stacked leaves, the f32
    gate weights and the norm scale among them."""
    cfg, _, rparams, params = bridged
    seg = segment_plan(cfg)[1]
    assert (seg.layers, seg.period, seg.n_periods) == ((1, 2, 3), 1, 3)
    stack = rparams["segments"][1]["stack"][0]["mixer"]
    for r in range(3):
        mixer = params["segments"][1][r]["mixer"]
        for name in ("up", "conv_w", "w_i", "b_f"):
            np.testing.assert_array_equal(_np(mixer[name]),
                                          np.asarray(stack[name])[r])
        np.testing.assert_array_equal(
            _np(mixer["out_norm"]["scale"]),
            np.asarray(stack["out_norm"]["scale"])[r])
    assert cfg.layer_types[7] == "slstm" and \
        set(params["segments"][2][3]) == {"ln1", "mixer"}


# ------------------------------------------------------------------ models

def _ref_layer_caches(cfg, rcaches):
    out = []
    for seg, sc in zip(segment_plan(cfg), rcaches):
        layers = [dict(c) for c in sc["prefix"]]
        for r in range(seg.n_periods):
            for pos in range(seg.period):
                layers.append({n: np.asarray(a)[r]
                               for n, a in sc["stack"][pos].items()})
        out.append(layers)
    return out


def test_prefill_and_decode_logits_match_reference(bridged):
    """Prompts of 12 tokens, then 5 teacher-forced decode steps: every
    step's logits (the tied f32 head), each layer's cache (to 1e-3 of the
    leaf's largest magnitude) and the positions."""
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
                want = np.asarray(rc[n])
                assert tuple(c[n].shape) == want.shape
                np.testing.assert_allclose(
                    _np(c[n]), want, rtol=1e-3,
                    atol=1e-3 * max(1.0, float(np.abs(want).max())))
    assert kinds == {("C", "conv", "m", "n"), ("c", "conv", "h", "m", "n")}
    np.testing.assert_array_equal(_np(s["positions"]),
                                  np.asarray(rs["positions"]))


def test_prefill_then_decode_matches_full_forward(bridged):
    """tests/test_decode_consistency.py's check on reduced xLSTM: an
    8-token prefill, then 4 decode steps, give the logits of one 12-token
    pass at the same positions (the reference's full forward too)."""
    cfg, rcfg, rparams, params = bridged
    toks = np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 12))
    rh, _, _ = ref_model.forward(rcfg, RefFlags(), rparams,
                                 {"tokens": jnp.asarray(toks, jnp.int32)},
                                 "train")
    want = np.asarray(ref_model.head_logits(rparams["embed"], rh,
                                            tied=True))
    h, _, _ = port_model.forward(cfg, RunFlags(), params,
                                 {"tokens": _t(toks)}, "prefill")
    full = head_logits(params["embed"], h, tied=True)
    np.testing.assert_allclose(_np(full), want, **LOGITS)
    logits, state = port_model.build_prefill_step(cfg, RunFlags(),
                                                  max_len=16)(
        params, {"tokens": _t(toks[:, :8])})
    torch.testing.assert_close(logits, full[:, 7], **LOGITS)
    dec = port_model.build_decode_step(cfg, RunFlags())
    for t in range(8, 12):
        logits, state = dec(params, state, _t(toks[:, t]))
        torch.testing.assert_close(logits, full[:, t], **LOGITS)


def test_teacher_forced_logits_match_reference(bridged):
    """tests/test_torch_mamba.py's teacher-forced run on reduced xLSTM:
    the port's logits within 0.5 % of the largest logit of the
    reference's over 48 decode steps (rtol 1e-3); the stacked layers'
    gates carry f32 rounding through the steps."""
    port, ref = forced_runs(*bridged)
    top = max(np.abs(b).max() for b in ref)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=5e-3 * top)
