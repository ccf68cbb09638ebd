"""PyTorch port vs the JAX reference: the encoder and the stub frontends,
the non-causal mask and the bf16 score products.

hubert-xlarge (an encoder: audio frames normed and projected in place of
the token embedding, attention without the causal mask, no Engram) and
internvl2-1b (a decoder whose vision patches overwrite the first
positions of the token embedding; Engram from ``ENGRAM_27B``), full and
reduced, in float32 with weights bridged from the reference. Twins of
tests/test_archs_smoke.py's ``test_encoder_step``,
``test_engram_applicability`` and the forward half of
``test_forward_and_train_step`` (the train step waits for the training
modules), and of tests/test_perf_flags.py's
``test_bf16_scores_matches_baseline``.

F12 (ROADMAP §3): the reference's non-causal chunked attention lets the
padded keys of the last KV chunk into the softmax; the port masks them, so
its chunked encoder equals its dense one (and the reference's dense one)
at any length, and the reference's chunked path only where the length is
a multiple of ``kv_chunk``.

Tolerances: f32 logits 1e-5 (1e-4 after a whole stack), integers and
stats bit for bit; bf16 products within a bf16 ulp."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import ASSIGNED  # noqa: E402
from conftest import reduced as ref_reduced  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.configs import hubert_xlarge as ref_hubert  # noqa: E402
from repro.configs import internvl2_1b as ref_internvl  # noqa: E402
from repro.configs import gemma2_27b as ref_gemma2  # noqa: E402
from repro.configs import deepseek_v2_236b as ref_v2  # noqa: E402
from repro.data import DataConfig, TokenPipeline, frontend_features  # noqa: E402,E501
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro.serving import Engine as RefEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import deepseek_v2_236b, gemma2_27b  # noqa: E402
from repro_torch.configs import hubert_xlarge, internvl2_1b  # noqa: E402
from repro_torch.launch.train import reduced_config  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402
from repro_torch.models import mla as port_mla  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import head_logits  # noqa: E402
from repro_torch.models.params import from_jax, init_params  # noqa: E402
from repro_torch.models.transformer import RunFlags, segment_plan  # noqa: E402,E501
from repro_torch.serving import Engine  # noqa: E402

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2.0 ** -7, atol=1e-3)        # one bf16 ulp
MODULES = {"hubert-xlarge": (hubert_xlarge, ref_hubert),
           "internvl2-1b": (internvl2_1b, ref_internvl)}


def _bridge(rcfg, cfg, seed=0):
    rparams = ref_model.init_params(rcfg, seed)
    return rparams, from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")


@pytest.fixture(scope="module")
def bridged():
    """Per name: (port cfg, ref cfg, ref params, port params bridged)."""
    out = {}
    for name, (mod, ref_mod) in MODULES.items():
        cfg, rcfg = mod.reduced(), ref_mod.reduced()
        out[name] = (cfg, rcfg, *_bridge(rcfg, cfg))
    return out


def _batch(cfg, B=2, S=16, seed=0):
    """tests/test_archs_smoke.py's batch: tokens, labels, and the
    frontend's frames or patches, as numpy."""
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=B, seq_len=S, seed=seed)
    b = TokenPipeline(dc).batch_at(0)
    b.update(frontend_features(cfg, b["tokens"], seed))
    return b


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(batch, keys):
    return ({k: jnp.asarray(batch[k]) for k in keys},
            {k: _t(batch[k]) for k in keys})


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_configs_identical(name, size):
    """Field by field, with the reference's parameter counts, Engram
    layers and segment plan; the port's defs build, frontend included,
    with the reference's leaf shapes."""
    mod, ref_mod = MODULES[name]
    cfg, rcfg = getattr(mod, size)(), getattr(ref_mod, size)()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert cfg.engram_layers() == rcfg.engram_layers()
    assert [dataclasses.astuple(s) for s in segment_plan(cfg)] == \
        [dataclasses.astuple(s) for s in ref_transformer.segment_plan(rcfg)]
    defs = port_model.model_defs(cfg)
    rdefs = ref_model.model_defs(rcfg)
    assert defs["frontend"]["proj"].shape == rdefs["frontend"]["proj"].shape
    assert defs["frontend"]["norm"]["scale"].shape == \
        rdefs["frontend"]["norm"]["scale"].shape
    if size == "full":
        assert configs.get_config(name) == cfg
        assert configs.list_archs() == ref_base.list_archs()


# ------------------------------------------------------- the encoder (hubert)

def _encoder_logits(cfg, rcfg, rparams, params, batch, **chunking):
    rb, pb = _both(batch, ("tokens", "frames"))
    want = ref_model.build_encoder_step(rcfg, RefFlags(**chunking))(
        rparams, rb)
    got = port_model.build_encoder_step(cfg, RunFlags(**chunking))(
        params, pb)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_encoder_step_matches_reference(bridged, path):
    """Reduced hubert-xlarge's logits (B 2, S 24) against the reference's;
    chunked: ``chunk_threshold`` 8 with 8-token chunks, every q chunk
    attending all three KV chunks (24 is a multiple of 8: see F12)."""
    cfg, rcfg, rparams, params = bridged["hubert-xlarge"]
    chunking = dict(chunk_threshold=8, q_chunk=8, kv_chunk=8) \
        if path == "chunked" else {}
    got, want = _encoder_logits(cfg, rcfg, rparams, params,
                                _batch(cfg, S=24), **chunking)
    assert got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got, want, **LOGITS)


def test_f12_chunked_encoder_masks_pad_keys(bridged):
    """S = 2 * kv_chunk + 5: the port's chunked encoder equals its dense one
    and the reference's dense one; the reference's chunked path, whose
    last KV chunk carries 3 pad keys into the softmax, does not (F12)."""
    cfg, rcfg, rparams, params = bridged["hubert-xlarge"]
    batch = _batch(cfg, S=21)
    chunking = dict(chunk_threshold=8, q_chunk=8, kv_chunk=8)
    dense, ref_dense = _encoder_logits(cfg, rcfg, rparams, params, batch)
    chunked, ref_chunked = _encoder_logits(cfg, rcfg, rparams, params, batch,
                                           **chunking)
    np.testing.assert_allclose(dense, ref_dense, **LOGITS)
    np.testing.assert_allclose(chunked, dense, **LOGITS)
    assert np.abs(ref_chunked - ref_dense).max() > 5e-3      # 9.6e-3


def test_chunk_attn_non_causal_masks_pad_keys():
    """``_chunk_attn(causal=False)`` at S = 2 * kv_chunk + 5 (q chunks of 8,
    KV chunks of 8, the last holding 5 keys and 3 pads) against ``_sdpa``
    with a full mask, and against the causal path where both apply."""
    cfg = hubert_xlarge.reduced()
    rng = np.random.RandomState(3)
    S, hd = 2 * 8 + 5, cfg.head_dim
    q, k, v = (_t(rng.randn(2, S, cfg.n_heads, hd).astype(np.float32))
               for _ in range(3))
    pos = torch.arange(S)
    full = port_attn._sdpa(cfg, q, k, v, torch.ones(1, S, S, dtype=bool))
    got = port_attn._chunk_attn(cfg, q, k, v, pos, pos, causal=False,
                                q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **F32)
    causal = port_attn._sdpa(cfg, q, k, v,
                             port_attn._mask(pos, pos, causal=True)[None])
    got = port_attn._chunk_attn(cfg, q, k, v, pos, pos, causal=True,
                                q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), causal.numpy(), **F32)


def test_encoder_attends_forward(bridged):
    """Frames changed at the last 5 positions move the logits at position
    0: the encoder's mask is not causal (a decoder's would not move)."""
    cfg, _, _, params = bridged["hubert-xlarge"]
    batch = _batch(cfg, S=24)
    step = port_model.build_encoder_step(cfg, RunFlags())
    a = step(params, {"frames": _t(batch["frames"])})
    fr = batch["frames"].copy()
    fr[:, -5:] += 1.0
    b = step(params, {"frames": _t(fr)})
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-3


def test_encoder_step(bridged):
    """tests/test_archs_smoke.py::test_encoder_step's twin: (B, S, V)
    logits, all finite, from seeded port parameters."""
    cfg = reduced_config("hubert-xlarge")
    assert cfg.is_encoder
    params = init_params(cfg, 0, "cpu")
    batch = _batch(cfg)
    logits = port_model.build_encoder_step(cfg, RunFlags())(
        params, {k: _t(batch[k]) for k in ("tokens", "frames")})
    B, S = batch["tokens"].shape
    assert logits.shape == (B, S, cfg.vocab_size)
    assert torch.isfinite(logits).all()


# ----------------------------------------------- the vision stub (internvl2)

def test_embed_inputs_with_patches(bridged):
    """``embed_inputs`` with and without the 8 patch tokens against the
    reference's: patches normed, projected, written over positions [0, 8);
    the text positions untouched."""
    cfg, rcfg, rparams, params = bridged["internvl2-1b"]
    batch = _batch(cfg)
    rb, pb = _both(batch, ("tokens", "patches"))
    want = ref_model.embed_inputs(rcfg, rparams, rb)
    got = port_model.embed_inputs(cfg, params, pb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    plain = port_model.embed_inputs(cfg, params, {"tokens": pb["tokens"]})
    P = cfg.n_patch_tokens
    assert torch.equal(got[:, P:], plain[:, P:])
    assert not torch.allclose(got[:, :P], plain[:, :P])


@pytest.mark.parametrize("patches", [True, False])
def test_vision_prefill_matches_reference(bridged, patches):
    """Prefill logits of 16-token prompts (lengths 16 and 11), with the
    batch's 8 patch tokens and without, against the reference's; the KV
    leaves too. With patches the logits differ from the tokens-only
    ones."""
    cfg, rcfg, rparams, params = bridged["internvl2-1b"]
    batch = _batch(cfg)
    batch["lengths"] = np.array([16, 11], np.int32)
    keys = ("tokens", "lengths") + (("patches",) if patches else ())
    rb, pb = _both(batch, keys)
    want, rstate = jax.jit(ref_model.build_prefill_step(
        rcfg, RefFlags(), max_len=24))(rparams, rb)
    got, state = port_model.build_prefill_step(cfg, RunFlags(),
                                               max_len=24)(params, pb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    rk = rstate["caches"][0]["prefix"][0]["k"] \
        if rstate["caches"][0]["prefix"] else None
    if rk is not None:
        np.testing.assert_allclose(state["caches"][0][0]["k"].numpy(),
                                   np.asarray(rk), **F32)
    np.testing.assert_array_equal(state["last_tokens"].numpy(),
                                  np.asarray(rstate["last_tokens"]))
    if patches:
        plain, _ = port_model.build_prefill_step(cfg, RunFlags())(
            params, {k: pb[k] for k in ("tokens", "lengths")})
        assert (plain - got).abs().max() > 1e-3


def test_vision_engine_matches_reference(bridged):
    """Reduced internvl2-1b through the reference's ``Engine`` and the
    port's (tokens only, as the reference engine serves it), ``pool="CXL"``
    at the emulated operating point: identical streams, ``StoreStats`` and
    clock."""
    cfg, rcfg, rparams, params = bridged["internvl2-1b"]
    rng = np.random.RandomState(9)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
               for n in (5, 11, 3, 8)]
    kw = dict(pool="CXL", max_batch=2, max_len=48, prompt_bucket=8,
              emulate_step_s=5e-5)
    runs = []
    for eng in (RefEngine(rcfg, params=rparams, **kw),
                Engine(cfg, params=params, device="cpu", **kw)):
        rids = [eng.submit(list(p), max_new=8) for p in prompts]
        eng.run()
        runs.append((eng, [eng.done[r].out for r in rids]))
    (ref, want), (eng, got) = runs
    assert got == want and all(len(s) == 8 for s in got)
    assert dataclasses.asdict(eng.store.stats()) == \
        dataclasses.asdict(ref.store.stats())
    assert eng.clock.stats() == ref.clock.stats()


# ------------------------------------------------ every arch, the forward

@pytest.mark.parametrize("arch", ASSIGNED)
def test_forward_logits_match_reference(arch):
    """The forward half of tests/test_archs_smoke.py's
    ``test_forward_and_train_step``: the reduced config's train-mode
    forward (frames or patches included) and head over a (2, 16) batch,
    all finite and against the reference's. Through the recurrent stacks
    within 2e-3 of the largest logit (tests/test_torch_xlstm.py's
    tolerance), elsewhere 1e-4."""
    cfg, rcfg = reduced_config(arch), ref_reduced(arch)
    rparams, params = _bridge(rcfg, cfg)
    batch = _batch(cfg)
    keys = [k for k in ("tokens", "frames", "patches") if k in batch]
    rb, pb = _both(batch, keys)
    h, _, _ = ref_model.forward(rcfg, RefFlags(), rparams, rb, "train")
    want = np.asarray(ref_layers.head_logits(
        ref_model._head_params(rcfg, rparams), h, rcfg.final_logit_softcap,
        rcfg.tie_embeddings))
    got, _, _ = port_model.forward(cfg, RunFlags(), params, pb, "train")
    got = head_logits(port_model._head_params(cfg, params), got,
                      cfg.final_logit_softcap, cfg.tie_embeddings).numpy()
    assert got.shape == (2, 16, cfg.vocab_size) and np.isfinite(got).all()
    if "mamba" in cfg.layer_types or "mlstm" in cfg.layer_types:
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, **LOGITS)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_engram_applicability(arch):
    """tests/test_archs_smoke.py's twin: Engram is wired for every arch
    except the continuous-input encoder, and the port's parameter tree
    carries its tables exactly when it is."""
    cfg = reduced_config(arch)
    full_has = cfg.engram is not None and bool(cfg.engram_layers())
    assert full_has == (arch != "hubert-xlarge"), arch
    assert ("engram" in port_model.model_defs(cfg)) == full_has


# ------------------------------------------------------------- bf16 scores

def _decode_logits(cfg, params, tokens, flags, steps=4):
    prefill = port_model.build_prefill_step(cfg, flags, max_len=40)
    decode = port_model.build_decode_step(cfg, flags)
    logits, state = prefill(params, {"tokens": tokens})
    outs = [logits.numpy()]
    tok = logits.argmax(-1)
    for _ in range(steps):
        logits, state = decode(params, state, tok)
        outs.append(logits.numpy())
        tok = logits.argmax(-1)
    return outs


@pytest.fixture(scope="module")
def gemma2():
    cfg, rcfg = gemma2_27b.reduced(), ref_gemma2.reduced()
    rparams, params = _bridge(rcfg, cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=24, seed=0)
    return cfg, rcfg, rparams, params, TokenPipeline(dc).batch_at(0)


def test_bf16_scores_matches_baseline(gemma2):
    """tests/test_perf_flags.py's twin on reduced gemma2-27b (local and
    global layers, softcaps): prefill then 4 decode steps with
    ``attn_bf16_scores`` against the default, within its 2e-3."""
    cfg, _, _, params, batch = gemma2
    toks = _t(batch["tokens"])
    base = _decode_logits(cfg, params, toks, RunFlags())
    opt = _decode_logits(cfg, params, toks, RunFlags(attn_bf16_scores=True))
    for b, o in zip(base, opt):
        np.testing.assert_allclose(o, b, rtol=2e-3, atol=2e-3)


def test_bf16_scores_match_reference_in_bf16(gemma2):
    """The same model cast to bf16: the port's ``attn_bf16_scores`` logits
    against the reference's (its ``preferred_element_type`` route) and
    against the port's own f32-score path, each within a bf16 ulp of the
    largest logit per step; and ``_sdpa``'s bf16 scores on bf16 operands
    equal to an f32 evaluation of the same bf16 numbers."""
    cfg, rcfg, rparams, _, batch = gemma2
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    rcfg16 = dataclasses.replace(rcfg, dtype="bfloat16")
    rp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if a.dtype == jnp.float32 and a.ndim > 1 else a,
                        rparams)
    p16 = from_jax(jax.tree.map(np.asarray, rp16), cfg16, device="cpu")
    toks = batch["tokens"][:, :16]
    pre = jax.jit(ref_model.build_prefill_step(
        rcfg16, RefFlags(attn_bf16_scores=True), max_len=24))
    want, _ = pre(rp16, {"tokens": jnp.asarray(toks)})
    got = _decode_logits(cfg16, p16, _t(toks),
                         RunFlags(attn_bf16_scores=True), steps=2)
    f32s = _decode_logits(cfg16, p16, _t(toks), RunFlags(), steps=2)
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert np.abs(got[0] - want).max() <= 2.0 ** -7 * scale
    for g, f in zip(got, f32s):
        assert np.abs(g - f).max() <= 2.0 ** -7 * np.abs(f).max()
    rng = np.random.RandomState(2)
    q, k, v = (_t(rng.randn(2, 5, n, cfg.head_dim).astype(np.float32))
               .bfloat16() for n in (cfg.n_heads, cfg.n_kv_heads,
                                     cfg.n_kv_heads))
    mask = torch.ones(1, 5, 5, dtype=torch.bool)
    a = port_attn._sdpa(cfg, q, k, v, mask, bf16_scores=True)
    b = port_attn._sdpa(cfg, q.float(), k.float(), v.bfloat16(), mask)
    assert torch.equal(a, b)
    ra = ref_attn._sdpa(rcfg, *(jnp.asarray(x.float().numpy())
                                .astype(jnp.bfloat16) for x in (q, k, v)),
                        jnp.asarray(mask.numpy()), True)
    np.testing.assert_allclose(a.float().numpy(),
                               np.asarray(ra.astype(jnp.float32)), **BF16)


def test_mla_bf16_scores_match_reference():
    """MLA's absorbed decode with ``bf16_scores`` on bf16 weights and a
    bf16 latent cache (reduced deepseek-v2-236b's layer 0) against the
    reference's f32-score decode of the same bf16 numbers and the port's
    own, within a bf16 ulp of the largest output; the cache is written in
    place either way. (The reference's bf16-score MLA decode does not run
    on the CPU: XLA's CPU dot has no BF16 x BF16 = F32 kernel for it.)"""
    cfg = dataclasses.replace(deepseek_v2_236b.reduced(), dtype="bfloat16")
    rcfg = dataclasses.replace(ref_v2.reduced(), dtype="bfloat16")
    rm = ref_model.init_params(rcfg, 0)["segments"][0]["prefix"][0]["mixer"]
    pm = {n: {"scale": _t(np.asarray(a["scale"]))} if isinstance(a, dict)
          else _t(np.asarray(a.astype(jnp.float32))).bfloat16()
          for n, a in rm.items()}
    rng = np.random.RandomState(8)
    B, Smax, m = 3, 10, cfg.mla
    x = jnp.asarray(rng.randn(B, 1, cfg.d_model)).astype(jnp.bfloat16)
    cache = {"c_kv": rng.randn(B, Smax, m.kv_lora_rank),
             "k_rope": rng.randn(B, Smax, m.qk_rope_head_dim)}
    rc = {n: jnp.asarray(v).astype(jnp.bfloat16) for n, v in cache.items()}
    pos = np.array([0, 4, 9])
    want, _ = ref_mla.mla_decode(rcfg, rm, x, rc, jnp.asarray(pos))
    want = np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    for bf16 in (True, False):
        pc = {n: _t(np.asarray(v.astype(jnp.float32))).bfloat16()
              for n, v in rc.items()}
        got, gc = port_mla.mla_decode(
            cfg, pm, _t(np.asarray(x.astype(jnp.float32))).bfloat16(), pc,
            _t(pos), bf16_scores=bf16)
        assert gc["c_kv"] is pc["c_kv"]
        assert np.abs(got.float().numpy() - want).max() <= \
            2.0 ** -7 * scale, bf16
