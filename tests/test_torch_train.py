"""PyTorch port vs the JAX reference: training (``repro_torch.data``,
``models.model.build_loss_fn``, ``train/``, ``launch/train.py``), on the
CPU in float32.

* Twins of tests/test_train_loop.py: the loss falls, grad accumulation
  matches the full batch, an injected failure and restart replays the
  uninterrupted run, a failure without checkpoints raises, the data is
  deterministic and carries its n-gram structure, int8 quantisation's
  error bound.
* A twin of tests/test_perf_flags.py's ``test_xent_remat_exact``, and the
  same for the layer remat (``RunFlags.remat``).
* Every reduced arch of the assignment: the port's loss and every
  gradient against the reference's ``jax.value_and_grad`` on the
  reference's weights (``from_jax``; the reference's gradients mapped
  with ``from_jax`` too). Loss within 1e-5 relative. Each gradient
  within a share of its leaf's largest: 1e-4, the recurrent archs 2e-3
  (``GRAD_TOL``), or, where the reference's own jitted gradients move
  further when its weights move by about one ulp (five seeded
  witnesses, measured in the fixture), the largest of those moves.
* ``adamw_update`` alone on equal gradients against the reference's at
  1e-6, with a learning rate at which weight decay moves every leaf by
  about 1e-3: the stacked layer norms decayed, ``final_norm`` and the
  Engram ``norm`` not (``decay_mask``).
* ``TokenPipeline`` batches and the frontend stubs bit-equal to the
  reference's; the reference's ``train`` against the port's over 10
  steps (the port restores the reference's step-0 weights from a
  checkpoint), losses within 1e-4; the CLI; a trainer's parameters
  (``requires_grad``) served by ``Engine`` as a detached copy is.
* The guards: K1 and K2 raise on a device call autograd would record;
  ``--mesh`` outside torchrun raises.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import ASSIGNED, reduced  # noqa: E402
from repro import train as ref_train  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import make_batch as ref_make_batch  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.data import (DataConfig, TokenPipeline,  # noqa: E402
                              make_batch, shard_batch)
from repro_torch.data.pipeline import _successors  # noqa: E402
from repro_torch.kernels.engram_gather import gather_rows_multi  # noqa: E402
from repro_torch.kernels.gated_fuse import engram_gated_fuse  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import reduced_config  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.params import (from_jax, init_params,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.models.transformer import RunFlags  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.train import (AdamWConfig, SimulatedFailure,  # noqa: E402
                               TrainConfig, build_train_step, dequantize,
                               init_opt_state, quantize, train,
                               train_with_restarts)
from repro_torch.train.loop import value_and_grad  # noqa: E402
from repro_torch.train.optimizer import adamw_update, decay_mask  # noqa: E402

torch.set_num_threads(2)

# ISSUE-level gradient tolerances, a share of each leaf's largest: 1e-4,
# and the recurrent archs' (exponential gates, long products) 2e-3
GRAD_TOL = {"xlstm-125m": 2e-3, "jamba-1.5-large-398b": 2e-3}
# the reference's own conditioning: its jitted gradients from its weights
# moved by about one f32 ulp (a relative 1e-7), one run per seed
WITNESS_SEEDS = (1, 2, 3, 4, 5)


def tiny_cfg(mod=reduced_config):
    """tests/test_train_loop.py's tiny config: 2 layers of reduced
    deepseek-7b, Engram at layer 1."""
    cfg = mod("deepseek-7b")
    return dataclasses.replace(cfg, n_layers=2, layer_types=("attn",) * 2,
                               attn_kinds=("global",) * 2,
                               ffn_types=("dense",) * 2,
                               engram=dataclasses.replace(cfg.engram,
                                                          layers=(1,)))


def dc_for(cfg, batch=4, seq=32, cls=DataConfig):
    return cls(vocab_size=cfg.vocab_size, batch=batch, seq_len=seq, seed=3)


def _np(t):
    return t.detach().float().numpy()


def _quiet(s):
    pass


# ---------------------------------------------------------------- loop twins

def test_loss_decreases():
    cfg = tiny_cfg()
    tc = TrainConfig(steps=30, log_every=100, ckpt_every=1000)
    res = train(cfg, tc, dc_for(cfg), oc=AdamWConfig(lr=3e-3, warmup_steps=3,
                                                     decay_steps=30),
                log=_quiet, device="cpu")
    first = np.mean(res.losses[:5])
    last = np.mean(res.losses[-5:])
    assert last < first - 0.1, (first, last)


def test_grad_accum_matches_full_batch():
    cfg = tiny_cfg()
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, grad_clip=0.0)
    params = init_params(cfg, 0, "cpu")
    batch = shard_batch(TokenPipeline(dc_for(cfg, 4, 16)).batch_at(0),
                        device="cpu")
    p1, p2 = (tree_map(torch.clone, params) for _ in range(2))
    _, _, m1 = build_train_step(cfg, RunFlags(), oc, 1)(
        p1, init_opt_state(p1), batch)
    _, _, m2 = build_train_step(cfg, RunFlags(), oc, 2)(
        p2, init_opt_state(p2), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    # AdamW's m/(sqrt(v)+eps) amplifies summation-order noise where
    # grad ~ 0: the reference's looser elementwise bound
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=5e-3, atol=1e-4)


def test_failure_injection_and_restart(tmp_path, monkeypatch):
    """Crash at step 12, restart, resume from the step-10 checkpoint,
    finish: the final losses match an uninterrupted run."""
    cfg = tiny_cfg()
    tc = TrainConfig(steps=20, ckpt_every=10, log_every=100)
    dc = dc_for(cfg)
    kw = dict(oc=AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=20),
              log=_quiet, device="cpu")
    ref = train(cfg, tc, dc, ckpt_dir=str(tmp_path / "ref"), **kw)
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "12")
    res = train_with_restarts(cfg, tc, dc, ckpt_dir=str(tmp_path / "ft"),
                              **kw)
    assert res.restarts == 1
    assert res.final_step == 20
    assert "REPRO_FAIL_AT_STEP" not in os.environ     # fails once
    np.testing.assert_allclose(res.losses[-5:], ref.losses[-5:], rtol=1e-4)


def test_failure_without_checkpointing_raises(monkeypatch):
    cfg = tiny_cfg()
    tc = TrainConfig(steps=6, ckpt_every=100, log_every=100)
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "3")
    with pytest.raises(SimulatedFailure):
        train(cfg, tc, dc_for(cfg), log=_quiet, device="cpu")


def test_data_determinism():
    dc = DataConfig(vocab_size=1000, batch=4, seq_len=64, seed=9)
    p1, p2 = TokenPipeline(dc), TokenPipeline(dc)
    b1, b2 = p1.batch_at(17), p2.batch_at(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # labels are the shifted stream
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_data_has_ngram_structure():
    """The successor-table fraction of transitions is about ngram_p."""
    dc = DataConfig(vocab_size=1000, batch=8, seq_len=256, seed=1,
                    ngram_p=0.6)
    succ = _successors(dc)
    t = TokenPipeline(dc).batch_at(0)["tokens"]
    hits = (succ[t[:, :-1] % succ.shape[0]] == t[:, 1:]).mean()
    assert 0.45 < hits < 0.75, hits


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.RandomState(0).randn(513) * 3.0).float()
    q, s = quantize(x)
    back = dequantize(q, s)
    assert q.dtype == torch.int8
    assert float((back - x).abs().max()) <= float(s) * 0.5 + 1e-7
    rq, rs = ref_train.quantize(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)


# ---------------------------------------------------------------- the data

@pytest.mark.parametrize("arch", ["deepseek-7b", "hubert-xlarge",
                                  "internvl2-1b"])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_batches_bit_equal_reference(arch, shard):
    """``make_batch`` (tokens, labels, the audio frames or vision patches)
    equals the reference's bit for bit, for a data shard too."""
    sid, n = shard
    kw = dict(batch=4, seq_len=24, seed=5, shard_id=sid, n_shards=n)
    cfg, rcfg = reduced_config(arch), reduced(arch)
    for step in (0, 7):
        got = make_batch(cfg, DataConfig(vocab_size=cfg.vocab_size, **kw),
                         step)
        want = ref_make_batch(rcfg, RefDataConfig(
            vocab_size=rcfg.vocab_size, **kw), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_shard_batch_places_and_blocks():
    """No context: the batch as tensors on the device. Under a sharding
    context: the rank's block of the batch axis, as the reference places
    it (data rank 1 of 2 holds rows 2 and 3)."""
    from repro_torch.sharding.rules import Mesh, sharding_ctx
    b = TokenPipeline(DataConfig(vocab_size=50, batch=4, seq_len=8)
                      ).batch_at(0)
    whole = shard_batch(b, device="cpu")
    assert all(torch.equal(whole[k], torch.from_numpy(v))
               for k, v in b.items())
    mesh = Mesh.of((2, 2), ("data", "model"), coords={"data": 1,
                                                      "model": 0})
    with sharding_ctx(mesh) as ctx:
        got = shard_batch(b, ctx, "cpu")
    assert torch.equal(got["tokens"], whole["tokens"][2:])


def test_opt_state_axes_match_reference():
    """ZeRO's "opt" axis on the first unsharded dim, none on the pooled
    tables, on the leaves both packages lay out alike."""
    from repro.configs import engram_27b as ref_engram_27b
    from repro_torch.configs import engram_27b
    from repro_torch.train import opt_state_axes
    got = opt_state_axes(port_model.params_logical_axes(engram_27b.reduced()))
    want = ref_opt.opt_state_axes(ref_model.params_logical_axes(
        ref_engram_27b.reduced()))
    for k in ("embed", "final_norm", "engram"):
        assert got["m"][k] == want["m"][k], k
    assert got["m"]["engram"]["layers"][0]["tables"] == (
        None, "eng_vocab", None)
    assert got["step"] == ()


# ------------------------------------------------------------ loss and grads

@pytest.fixture(scope="module")
def gemma2():
    cfg = reduced_config("gemma2-27b")      # local+global layers, softcap
    params = init_params(cfg, 0, "cpu")
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=24, seed=0)
    return cfg, params, shard_batch(TokenPipeline(dc).batch_at(0),
                                    device="cpu")


@pytest.mark.parametrize("flag", ["xent_remat", "remat"])
def test_remat_exact(gemma2, flag):
    """Recomputation changes the schedule, not the math: the loss and every
    gradient as without it (test_perf_flags.py's tolerances), with the
    logits in two chunks."""
    cfg, params, batch = gemma2
    base = RunFlags(logits_chunk=32)
    l0, g0 = value_and_grad(port_model.build_loss_fn(cfg, base), params,
                            batch)
    l1, g1 = value_and_grad(port_model.build_loss_fn(
        cfg, dataclasses.replace(base, **{flag: True})), params, batch)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5, atol=1e-6)


def _moved(tree, seed, eps=1e-7):
    """The reference's weights, each element times (1 + eps N(0, 1))."""
    leaves, tdef = jax.tree.flatten(tree)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(tdef, [
        x * (1 + eps * jax.random.normal(k, x.shape, x.dtype))
        for x, k in zip(leaves, keys)])


def _share(got, want) -> float:
    """The largest over leaves of max |got - want| / max |want|."""
    return max(float(np.abs(_np(g) - _np(w)).max()
                     / max(float(np.abs(_np(w)).max()), 1e-30))
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


@pytest.fixture(scope="module", params=ASSIGNED)
def arch_grads(request):
    """(arch, the reference's loss and gradients, the port's loss and
    gradients on the bridged weights and the same batch, and the
    reference's own witnesses: the share by which its gradients move when
    its weights move by about one ulp, per ``WITNESS_SEEDS``)."""
    arch = request.param
    cfg, rcfg = reduced_config(arch), reduced(arch)
    rparams = ref_model.init_params(rcfg, 0)
    dc = RefDataConfig(vocab_size=rcfg.vocab_size, batch=2, seq_len=16,
                       seed=0)
    b = ref_make_batch(rcfg, dc, 0)
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    ref_vg = jax.jit(jax.value_and_grad(ref_model.build_loss_fn(
        rcfg, RefFlags())))

    def bridged(tree):
        return from_jax(jax.tree.map(np.asarray, tree), cfg, "cpu")

    rl, rg = ref_vg(rparams, rb)
    want = bridged(rg)
    witness = [_share(bridged(ref_vg(_moved(rparams, s), rb)[1]), want)
               for s in WITNESS_SEEDS]
    l, g = value_and_grad(port_model.build_loss_fn(cfg, RunFlags()),
                          bridged(rparams), shard_batch(b, device="cpu"))
    return arch, float(rl), want, float(l), g, witness


def test_loss_matches_reference(arch_grads):
    arch, rl, _, l, _, _ = arch_grads
    np.testing.assert_allclose(l, rl, rtol=1e-5, err_msg=arch)


def test_every_gradient_matches_reference(arch_grads):
    """Each leaf's gradient within a share of that leaf's largest reference
    gradient: ``GRAD_TOL`` (1e-4, recurrent 2e-3), or, where the
    reference's own gradients move further under a one-ulp change of its
    weights, the largest such move over ``WITNESS_SEEDS`` (the port then
    parts no more than the reference parts from itself). The Engram
    tables, gate and proj nonzero."""
    arch, _, want, _, got, witness = arch_grads
    limit = max(GRAD_TOL.get(arch, 1e-4), max(witness))
    print(f"{arch}: port {_share(got, want):.2e} of a leaf's largest, "
          f"limit {limit:.2e}, witnesses "
          + " ".join(f"{x:.2e}" for x in witness))
    n = 0
    for w, g in zip(tree_leaves(want), tree_leaves(got)):
        assert g.shape == w.shape and g.dtype == w.dtype
        w, g = _np(w), _np(g)
        top = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=limit * top + 1e-30,
                                   err_msg=f"{arch} leaf {n}")
        n += 1
    if "engram" in got:
        for layer in got["engram"]["layers"]:
            for k in ("tables", "gate", "proj"):
                assert layer[k].abs().max() > 0, (arch, k)


# ----------------------------------------------------------------- AdamW

def test_adamw_matches_reference_with_stacked_decay():
    """Two AdamW steps on equal random gradients, bridged, against the
    reference's at 1e-6. At lr 1e-2 decay moves each decayed leaf by about
    1e-3 of itself, so a norm decayed on the wrong side fails."""
    from repro.configs import engram_27b as ref_engram_27b
    from repro_torch.configs import engram_27b
    cfg, rcfg = engram_27b.reduced(), ref_engram_27b.reduced()
    oc = AdamWConfig(lr=1e-2, warmup_steps=1, grad_clip=0.5)
    roc = ref_opt.AdamWConfig(lr=1e-2, warmup_steps=1, grad_clip=0.5)
    rparams = ref_model.init_params(rcfg, 0)
    rng = np.random.RandomState(0)
    rgrads = [jax.tree.map(lambda p: jnp.asarray(
        rng.randn(*p.shape).astype(np.float32) * 0.1), rparams)
        for _ in range(2)]
    rstate = ref_opt.init_opt_state(rparams)
    params = from_jax(jax.tree.map(np.asarray, rparams), cfg, "cpu")
    state = init_opt_state(params)
    decay = decay_mask(cfg)
    rp = rparams
    for rg in rgrads:
        rp, rstate, rm = ref_opt.adamw_update(roc, rp, rg, rstate)
        g = from_jax(jax.tree.map(np.asarray, rg), cfg, "cpu")
        params, state, m = adamw_update(oc, params, g, state, decay)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(rstate["step"]) == 2
    for key in ("params", "m", "v"):
        got = params if key == "params" else state[key]
        want = from_jax(jax.tree.map(np.asarray, rp if key == "params"
                                     else rstate[key]), cfg, "cpu")
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            # 1e-6 of the leaf's scale: p - lr * delta cancels where the
            # two are close, leaving the operands' last-bit differences
            b = _np(b)
            np.testing.assert_allclose(_np(a), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=key)
    # the trap: the stacked segments' norms are decayed, the rest are not
    assert not decay["final_norm"]["scale"]
    assert not decay["engram"]["layers"][0]["norm"]["scale"]
    stacked = [b["ln1"]["scale"] for seg, blocks in
               zip(port_model.segment_plan(cfg), decay["segments"])
               for b in blocks[seg.prefix_len:] if seg.period]
    assert stacked and all(stacked)


# ------------------------------------------------ the trainer against the ref

def test_train_matches_reference_over_ten_steps(tmp_path):
    """The reference's ``train`` and the port's over 10 steps from the same
    weights (the port restores the reference's init from a step-0
    checkpoint): each step's loss within 1e-4."""
    cfg, rcfg = tiny_cfg(), tiny_cfg(lambda a: reduced(a))
    kw = dict(steps=10, log_every=100, ckpt_every=1000)
    ref = ref_train.train(rcfg, ref_train.TrainConfig(**kw),
                          dc_for(rcfg, cls=RefDataConfig),
                          oc=ref_opt.AdamWConfig(lr=3e-3, warmup_steps=3,
                                                 decay_steps=10),
                          log=_quiet)
    params = from_jax(jax.tree.map(np.asarray, ref_model.init_params(
        rcfg, 0)), cfg, "cpu")
    Checkpointer(tmp_path, async_write=False).save(
        0, {"params": params, "opt": init_opt_state(params)})
    res = train(cfg, TrainConfig(**kw), dc_for(cfg),
                oc=AdamWConfig(lr=3e-3, warmup_steps=3, decay_steps=10),
                ckpt_dir=str(tmp_path), log=_quiet, device="cpu")
    assert res.steps_run == 10
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4)


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "m.json"
    assert train_cli.main(["--arch", "deepseek-7b", "--reduced", "--steps",
                           "6", "--batch", "2", "--seq", "16", "--device",
                           "cpu", "--log-every", "3", "--metrics-out",
                           str(out)]) == 0
    assert "[train] done: 6 steps" in capsys.readouterr().out
    import json
    m = json.loads(out.read_text())
    assert len(m["losses"]) == 6 and m["final_step"] == 6


def test_cli_mesh_raises(monkeypatch):
    """``--mesh`` trains one process per rank: outside torchrun (no
    ``RANK`` in the environment) and without an ``init_method`` it raises
    before touching a process group (tests/test_torch_multidev.py trains
    on a two-rank mesh through ``main``)."""
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_cli.main(["--reduced", "--mesh", "data=2", "--device", "cpu"])


def test_trainer_params_serve_like_a_detached_copy():
    """Parameters a trainer holds (``requires_grad``, after a step) give
    the same streams as a detached copy of them."""
    cfg = tiny_cfg()
    params = init_params(cfg, 0, "cpu")
    build_train_step(cfg, RunFlags(), AdamWConfig(lr=1e-3, warmup_steps=1))(
        params, init_opt_state(params), shard_batch(
            TokenPipeline(dc_for(cfg, 2, 16)).batch_at(0), device="cpu"))
    held = tree_map(lambda t: t.requires_grad_(), params)
    copy = tree_map(lambda t: t.detach().clone(), params)
    streams = []
    for p in (held, copy):
        eng = Engine(cfg, params=p, max_batch=2, max_len=64, device="cpu")
        rids = [eng.submit([5, 17, 42, 7], max_new=6),
                eng.submit([3, 9], max_new=6)]
        eng.run()
        streams.append([eng.done[r].out for r in rids])
    assert streams[0] == streams[1]
    assert all(t.requires_grad for t in tree_leaves(held))


# ---------------------------------------------------------------- the guards

def test_kernels_refuse_to_cut_a_gradient():
    """A device call that autograd would record raises before launching
    (``meta`` tensors stand for the card's: they reach the same branch);
    under ``no_grad`` the guard lets it through to the device checks,
    which refuse operands on two devices, and a meta call passes them to
    the kernel's shape function (the custom operator's, which launches
    nothing)."""
    h = torch.empty(4, 8, device="meta", requires_grad=True)
    e, wg, wp = (torch.empty(s, device="meta") for s in
                 ((4, 6), (8, 8), (6, 8)))
    with pytest.raises(RuntimeError, match="no backward"):
        engram_gated_fuse(h, e, wg, wp)
    tab = torch.empty(16, 4, device="meta", requires_grad=True)
    gid = torch.zeros(1, 3, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        gather_rows_multi([tab], gid)
    with torch.no_grad():
        with pytest.raises(ValueError):
            engram_gated_fuse(h, torch.empty(4, 6), wg, wp)
        with pytest.raises(ValueError):
            gather_rows_multi([torch.empty(16, 4)], gid)
        out = engram_gated_fuse(h, e, wg, wp)
        assert (out.device.type, tuple(out.shape)) == ("meta", (4, 8))
        rows = gather_rows_multi([tab], gid)
        assert (rows.device.type, tuple(rows.shape)) == ("meta", (1, 3, 4))


def test_example_twins_run(monkeypatch, capsys):
    """The twins of examples/quickstart.py and train_engram_lm.py run on
    the CPU; the latter crashes once at 60 % and restarts."""
    from repro_torch.examples import quickstart, train_engram_lm
    monkeypatch.delenv("REPRO_FAIL_AT_STEP", raising=False)
    loss, idx = quickstart.main(["--device", "cpu"])
    assert np.isfinite(loss) and idx.shape[:2] == (1, 5)
    res = train_engram_lm.main(["--steps", "10", "--layers", "2",
                                "--inject-failure", "--device", "cpu"])
    assert res.restarts == 1 and res.final_step == 10
    assert "REPRO_FAIL_AT_STEP" not in os.environ
    assert "[3] §3.2 feasibility" in capsys.readouterr().out
