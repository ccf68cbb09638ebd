"""PyTorch port vs the JAX reference: Multi-head Latent Attention and the
deepseek-v2/v3 configs on the CPU, in float32.

The MLA prefill path (decompressed keys 24 wide, values 16: the score
scale is 1/sqrt(24)) dense and through ``_chunk_attn``, the absorbed
decode path over the latent cache with per-slot positions, the reduced
deepseek-v2-236b and deepseek-v3-671b models' prefill and decode logits,
prefill then decode against one full pass, ``init_params``' distributions
for the MLA and expert leaves, and the decode state's latent KV leaves
(``c_kv``/``k_rope``, (B, S, R)) in the slot surgery: padding, prefix
snapshots and speculation snapshots.

Parameters come from the reference's ``init_params`` bridged with
``from_jax``; inputs are drawn with numpy. Tolerances: one layer's outputs
and the caches 1e-5 (f32 sums in another order), logits after the stack
1e-4, integers bit for bit."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import deepseek_v2_236b as ref_v2  # noqa: E402
from repro.configs import deepseek_v3_671b as ref_v3  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models.params import tree_init as ref_tree_init  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro.serving import slots as ref_slots  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import deepseek_v2_236b, deepseek_v3_671b  # noqa: E402
from repro_torch.models import mla as port_mla  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.layers import head_logits  # noqa: E402
from repro_torch.models.params import (from_jax, init_params,  # noqa: E402
                                       to_torch, tree_leaves, tree_map)
from repro_torch.models.transformer import RunFlags, segment_plan  # noqa: E402,E501
from repro_torch.serving import slots as port_slots  # noqa: E402

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
MODULES = {"deepseek-v2-236b": (deepseek_v2_236b, ref_v2),
           "deepseek-v3-671b": (deepseek_v3_671b, ref_v3)}


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


@pytest.fixture(scope="module")
def mla_layer():
    """One MLA layer of reduced deepseek-v2: (cfg, ref params, port
    params)."""
    cfg, rcfg = deepseek_v2_236b.reduced(), ref_v2.reduced()
    rparams = ref_tree_init(ref_mla.mla_defs(rcfg, "float32"), 3)
    params = tree_map(lambda a: to_torch(a, "cpu"),
                      jax.tree.map(np.asarray, rparams))
    return cfg, rcfg, rparams, params


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_configs_identical(name, size):
    """Field by field, with the reference's parameter counts (MLA and MoE
    lines of ``param_count`` and ``active_param_count``), Engram layers and
    segment plan, and its parameter defs build."""
    mod, ref_mod = MODULES[name]
    cfg, rcfg = getattr(mod, size)(), getattr(ref_mod, size)()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert cfg.engram_layers() == rcfg.engram_layers()
    assert [dataclasses.astuple(s) for s in segment_plan(cfg)] == \
        [dataclasses.astuple(s) for s in ref_transformer.segment_plan(rcfg)]
    port_model.model_defs(cfg)
    if size == "full":
        assert configs.get_config(name) == cfg


# ---------------------------------------------------------------- MLA layer

@pytest.mark.parametrize("chunked", [False, True])
def test_mla_attention_matches_reference(mla_layer, chunked):
    """Prefill over 20 positions: the output and both latent caches,
    dense (``_sdpa``) or with ``chunk_threshold`` below the prompt and
    8-position chunks (``_chunk_attn``, Dk 24 and Dv 16)."""
    cfg, rcfg, rparams, params = mla_layer
    kw = dict(chunk_threshold=8, q_chunk=8, kv_chunk=8) if chunked else {}
    h = np.random.RandomState(0).randn(2, 20, cfg.d_model).astype(np.float32)
    pos = np.arange(20)
    want, rcache = ref_mla.mla_attention(rcfg, rparams, jnp.asarray(h),
                                         jnp.asarray(pos), **kw)
    got, cache = port_mla.mla_attention(cfg, params, _t(h), _t(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert set(cache) == set(rcache) == {"c_kv", "k_rope"}
    for n in cache:
        assert cache[n].shape == rcache[n].shape
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(rcache[n]),
                                   **F32)


def test_mla_decode_matches_reference(mla_layer):
    """Absorbed decode over a 16-position latent cache at per-slot
    positions 3, 9 and 15 (15: the last row): the output, and the caches,
    written in place at each row's position."""
    cfg, rcfg, rparams, params = mla_layer
    rng = np.random.RandomState(1)
    m = cfg.mla
    cache = {"c_kv": rng.randn(3, 16, m.kv_lora_rank).astype(np.float32),
             "k_rope": rng.randn(3, 16, m.qk_rope_head_dim).astype(
                 np.float32)}
    h = rng.randn(3, 1, cfg.d_model).astype(np.float32)
    pos = np.array([3, 9, 15])
    want, rcache = ref_mla.mla_decode(
        rcfg, rparams, jnp.asarray(h), {n: jnp.asarray(a) for n, a in
                                        cache.items()},
        jnp.asarray(pos, jnp.int32))
    mine = {n: _t(a).clone() for n, a in cache.items()}
    got, out_cache = port_mla.mla_decode(cfg, params, _t(h), mine,
                                         _t(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for n in cache:
        assert out_cache[n] is mine[n]                     # in place
        np.testing.assert_allclose(mine[n].numpy(), np.asarray(rcache[n]),
                                   **F32)
        assert not np.array_equal(mine[n].numpy(), cache[n])


def test_init_mla_cache_matches_reference():
    cfg, rcfg = deepseek_v2_236b.reduced(), ref_v2.reduced()
    mine = port_mla.init_mla_cache(cfg, 2, 24, torch.float32, "cpu")
    want = ref_mla.init_mla_cache(rcfg, 2, 24, jnp.float32)
    assert {n: tuple(t.shape) for n, t in mine.items()} == \
        {n: a.shape for n, a in want.items()}


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


@pytest.mark.parametrize("name", sorted(MODULES))
def test_prefill_and_decode_logits_match_reference(bridged, name):
    """Prompts of 20 and 13 tokens, then 6 teacher-forced decode steps:
    every step's logits, the padded latent caches (zero past the prompt)
    and the positions against the reference's."""
    cfg, rcfg, rparams, params = bridged[name]
    rng = np.random.RandomState(2)
    toks = rng.randint(1, cfg.vocab_size, size=(2, 20))
    lens = np.array([20, 13])
    want, rs = jax.jit(ref_model.build_prefill_step(rcfg, RefFlags(),
                                                    max_len=32))(
        rparams, {"tokens": jnp.asarray(toks, jnp.int32),
                  "lengths": jnp.asarray(lens, jnp.int32)})
    got, s = port_model.build_prefill_step(cfg, RunFlags(), max_len=32)(
        params, {"tokens": _t(toks), "lengths": _t(lens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    for seg, rseg in zip(s["caches"], _ref_layer_caches(cfg, rs["caches"])):
        for c, rc in zip(seg, rseg):
            assert set(c) == {"c_kv", "k_rope"}
            for n in c:
                assert c[n].shape[1] == 32 and not c[n][:, 20:].any()
                np.testing.assert_allclose(c[n].numpy(), np.asarray(rc[n]),
                                           **LOGITS)
    rdec = jax.jit(ref_model.build_decode_step(rcfg, RefFlags()))
    dec = port_model.build_decode_step(cfg, RunFlags())
    for tok in rng.randint(1, cfg.vocab_size, size=(6, 2)):
        want, rs = rdec(rparams, rs, jnp.asarray(tok, jnp.int32))
        got, s = dec(params, s, _t(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_array_equal(s["positions"].numpy(),
                                  np.asarray(rs["positions"]))


def test_prefill_then_decode_matches_full_forward(bridged):
    """tests/test_decode_consistency.py's check on reduced deepseek-v2:
    an 8-token prefill, then 4 absorbed decode steps, give the logits of
    one 12-token decompressed pass at the same positions."""
    cfg, _, _, params = bridged["deepseek-v2-236b"]
    toks = _t(np.random.RandomState(0).randint(1, cfg.vocab_size, (2, 12)))
    h, _ = port_model.forward(cfg, RunFlags(), params, {"tokens": toks},
                              "prefill")
    full = head_logits(params["head"], h)
    logits, state = port_model.build_prefill_step(cfg, RunFlags(),
                                                  max_len=16)(
        params, {"tokens": toks[:, :8]})
    torch.testing.assert_close(logits, full[:, 7], **LOGITS)
    dec = port_model.build_decode_step(cfg, RunFlags())
    for t in range(8, 12):
        logits, state = dec(params, state, toks[:, t])
        torch.testing.assert_close(logits, full[:, t], **LOGITS)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", sorted(MODULES))
def test_init_params_mirrors_reference_distributions(bridged, name):
    """The port's seeded tree has the bridged tree's leaves, shapes and
    dtypes; every MLA and MoE leaf of 1000 elements or more has the
    reference's std within 0.1 (fan-in: the leading dimension, the expert
    count for an unstacked expert leaf, ``n_periods`` for a stacked one),
    and the draw is a function of the seed."""
    cfg, _, _, bparams = bridged[name]
    mine = dict(_paths(init_params(cfg, seed=3, device="cpu")))
    ref = dict(_paths(bparams))
    assert {p: (tuple(t.shape), t.dtype) for p, t in mine.items()} == \
        {p: (tuple(t.shape), t.dtype) for p, t in ref.items()}
    checked = set()
    for path, a in mine.items():
        if path[0] == "segments" and path[3] in ("mixer", "ffn") \
                and a.numel() >= 1000:
            ratio = a.std().item() / ref[path].std().item()
            assert abs(ratio - 1.0) < 0.1, (path, ratio)
            checked.add(path[4])
    assert {"wuq", "wuk", "wuv", "wo", "w_gu", "w_down"} <= checked
    again = dict(_paths(init_params(cfg, seed=3, device="cpu")))
    assert all(torch.equal(x, again[p]) for p, x in mine.items())


# ------------------------------------------------- latent KV slot surgery

def _prefilled(bridged, max_len=24):
    cfg, rcfg, rparams, params = bridged["deepseek-v2-236b"]
    rng = np.random.RandomState(4)
    toks = rng.randint(1, cfg.vocab_size, size=(3, 12))
    lens = np.array([12, 9, 5])
    rstate = jax.jit(ref_model.build_prefill_step(rcfg, RefFlags(),
                                                  max_len=max_len))(
        rparams, {"tokens": jnp.asarray(toks, jnp.int32),
                  "lengths": jnp.asarray(lens, jnp.int32)})[1]
    state = port_model.build_prefill_step(cfg, RunFlags(), max_len=max_len)(
        params, {"tokens": _t(toks), "lengths": _t(lens)})[1]
    return cfg, rstate, state


def test_pad_caches_pads_latent_sequence_axis():
    """``_pad_caches_to`` pads axis 1 of 3-D latents and 4-D k/v alike
    (a 4-D pad tuple on a (B, S, R) leaf would grow the batch axis)."""
    caches = [[{"c_kv": torch.ones(2, 5, 7), "k_rope": torch.ones(2, 5, 3)},
               {"k": torch.ones(2, 5, 4, 6), "v": torch.ones(2, 5, 4, 6)}]]
    out = port_model._pad_caches_to(caches, 9)[0]
    assert {n: tuple(t.shape) for kv in out for n, t in kv.items()} == \
        {"c_kv": (2, 9, 7), "k_rope": (2, 9, 3), "k": (2, 9, 4, 6),
         "v": (2, 9, 4, 6)}
    for kv in out:
        for t in kv.values():
            assert t[:, :5].eq(1).all() and not t[:, 5:].any()


def test_extract_restore_prefix_latents_match_reference(bridged):
    """A slot's prefix snapshot slices the latents to the prefix length,
    so its byte count (what the pool link is charged) is the
    reference's; restoring pads them back to capacity with zeros."""
    cfg, rstate, state = _prefilled(bridged)
    rsnap, rbytes = ref_slots.extract_prefix(rstate, 1, 8)
    snap, nbytes = port_slots.extract_prefix(state, 1, 8)
    assert nbytes == rbytes
    m = cfg.mla
    for seg, rseg in zip(snap["caches"],
                         _ref_layer_caches(cfg, rsnap["caches"])):
        for c, rc in zip(seg, rseg):
            assert tuple(c["c_kv"].shape) == (1, 8, m.kv_lora_rank)
            assert tuple(c["k_rope"].shape) == (1, 8, m.qk_rope_head_dim)
            for n in c:
                np.testing.assert_allclose(c[n].numpy(), rc[n], **LOGITS)
    back = port_slots.restore_prefix(snap, 24, torch.device("cpu"))
    for c, orig in zip(tree_leaves(back["caches"]),
                       tree_leaves(state["caches"])):
        assert c.shape == (1, 24, orig.shape[2])
        assert torch.equal(c[0, :8], orig[1, :8]) and not c[0, 8:].any()


def test_speculation_snapshots_skip_latents(bridged):
    """``snapshot_recurrent`` keeps no latent cache (the reference's KV
    leaves), and ``rollback_state`` keeps the final latent buffers while
    rewinding the positions per slot."""
    _, _, state = _prefilled(bridged)
    snap = port_slots.snapshot_recurrent(state)
    assert all(v is None for kv in _layer_dicts(snap["caches"])
               for v in kv.values())
    moved = dict(state, positions=state["positions"] + 2)
    back = port_slots.rollback_state(
        moved, [snap, port_slots.snapshot_recurrent(moved)],
        torch.tensor([0, 1, 0]))
    assert back["positions"].tolist() == [12, 11, 5]
    for a, b in zip(tree_leaves(back["caches"]),
                    tree_leaves(state["caches"])):
        assert a is b


def _layer_dicts(caches):
    """The per-layer cache dicts of a state's ``caches`` list."""
    return [kv for seg in caches for kv in seg]


def test_moe_strategy_flag_reaches_the_blocks(bridged):
    """``RunFlags.moe_strategy`` picks each MoE block's path, as the
    reference's does: the dense strategy's prefill logits against the
    reference's dense run, and against the port's default (ragged)."""
    cfg, rcfg, rparams, params = bridged["deepseek-v3-671b"]
    toks = np.random.RandomState(5).randint(1, cfg.vocab_size, size=(2, 9))
    want = jax.jit(ref_model.build_prefill_step(
        rcfg, RefFlags(moe_strategy="dense")))(
        rparams, {"tokens": jnp.asarray(toks, jnp.int32)})[0]
    got = port_model.build_prefill_step(
        cfg, RunFlags(moe_strategy="dense"))(params, {"tokens": _t(toks)})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    assert RunFlags().moe_strategy == RefFlags().moe_strategy == "gather"
    ragged = port_model.build_prefill_step(cfg, RunFlags())(
        params, {"tokens": _t(toks)})[0]
    torch.testing.assert_close(ragged, got, **LOGITS)
