"""PyTorch port vs the JAX reference: the mesh paths on a (2, 4)
("data", "model") mesh, on the CPU.

The reference runs in two subprocesses with 8 fake host devices each
(tests/torch_multidev_ref.py: the train steps in one, the rest in the
other, side by side; the pytest process stays at 1 device). The
port runs 8 gloo ranks, one process each (tests/torch_multidev_ranks.py),
with a ``file://`` rendezvous under the test's temporary directory. Both
get the same inputs, made here from numpy seeds and the reference's
``tree_init``/``init_params``; each rank's outputs are its blocks (its
share of the batch; ``tp``'s block of the fused dim too), reassembled here
and held against the reference's whole arrays:

  * ``retrieve`` tp and pooled (the mirror of tests/multidev_checks.py's
    ``check_engram_strategies``: a 4 x 8 batch, B = 1, every request on
    n-gram 42), and ``retrieve_pooled`` at slack 0.25, where requests
    overflow the owners' capacity: bit-equal in f32, the same zero rows;
  * ``moe_ffn`` gather and alltoall (``check_moe_ep``) at capacity factors
    8.0 and 1.0 (rows dropped) against the reference's same strategy and
    factor, at its tolerance (rtol 2e-4, atol 2e-5), aux within 1e-6; and
    alltoall on a sequence the expert axis does not divide (the gather
    route);
  * ``embed_lookup_local`` (``check_embed_local_gather``) on a (4096, 64)
    table, from the rank's block and from the whole table: bit-equal;
  * reduced deepseek-v3-671b's prefill and 4 greedy decode steps under the
    mesh (alltoall MoE, the vocab-sharded embedding, each rank holding
    ``local_params`` blocks): with tp retrieval against the reference's
    single-device prefill and decode (local, ragged), with pooled retrieval
    against the reference's forward under the same mesh and flags (its
    owners overflow, ROADMAP F13): logits within 1e-4, identical greedy
    tokens. Its capacity factor is 8.0, where the expert axis drops
    nothing (the single-device path drops nothing either).

Training under the mesh (each rank its blocks of ``train_logical_axes``,
gradients gathered whole):

  * each differentiable collective's gradient against the same sum
    computed whole on one process (f64), and ``embed_lookup_local``'s
    table gradient against the whole table's;
  * ``check_tp_train_step``'s twin (pooled and tp): the global loss within
    rtol 1e-4, every gradient within max(1e-4, the largest of five
    one-ulp witnesses) of its leaf's largest, grad_norm and one AdamW
    step at lr 1e-4 within tests/test_torch_train.py's AdamW tolerance or
    the reference's own one-ulp moves, against the reference's (2, 4)
    mesh step and its one-device step;
  * reduced deepseek-v2-236b's expert-parallel step (gather, alltoall) at
    its capacity factor 1.25 against the reference's mesh step, drops
    included, and with the capacity raised and the load-balance loss off
    against its one-device step;
  * a checkpointed period's backward recomputed on another thread;
  * the mesh trainer crashed and restarted, bit-equal to an uninterrupted
    run, its checkpoint restored onto an (8,) mesh; the training CLI on
    a (1, 2) mesh of ranks 0 and 1.

A hung rank fails the test: the process group times out after 120 s and
the ranks and the subprocess are killed after 300 s."""
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs.base import EngramConfig as RefEngramConfig  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.core.hashing import engram_indices  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.params import tree_init as ref_tree_init  # noqa: E402
from repro_torch.configs import deepseek_v3_671b  # noqa: E402
from repro_torch.configs.base import (EngramConfig, ModelConfig,  # noqa: E402
                                      MoEConfig)
from repro_torch.models.params import (from_jax, to_torch,  # noqa: E402
                                       tree_map, tree_paths)

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from torch_multidev_ranks import MESH, rank_main  # noqa: E402

WORLD = 8
TIMEOUT_S = 300
MOE_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/multidev_checks.py's
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_STEPS = 4
CAPACITY_FACTORS = (8.0, 1.0)
EP_CAPACITY = 1.25          # reduced deepseek-v2-236b's own


def _engram_cfg(cls):
    return cls(orders=(2, 3), n_heads=4, emb_dim=64, table_vocab=4096,
               layers=(1,), strategy="pooled")


def _moe_cfg(mcls, ecls, cf=8.0):
    return mcls(
        name="m", family="moe", n_layers=2, d_model=32, vocab_size=97,
        n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
        moe=ecls(n_experts=8, top_k=2, n_shared=1, d_ff_expert=48,
                 capacity_factor=cf),
        ffn_types=("moe", "moe"), dtype="float32")


def _ddp_cfg(mcls, ecls):
    """tests/multidev_checks.py's check_compressed_ddp model."""
    return mcls(name="d", family="dense", n_layers=2, d_model=32,
                vocab_size=101, n_heads=2, n_kv_heads=2, head_dim=16,
                d_ff=64, engram=ecls(orders=(2,), n_heads=2, emb_dim=32,
                                     table_vocab=1024, layers=(1,),
                                     strategy="local"),
                dtype="float32")


def _model_cfg(mod):
    import dataclasses
    cfg = mod.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def _tr_cfg(mcls, ecls):
    """tests/multidev_checks.py's check_tp_train_step model."""
    return mcls(name="t", family="dense", n_layers=3, d_model=64,
                vocab_size=128, n_heads=4, n_kv_heads=2, head_dim=16,
                d_ff=128, engram=_engram_cfg(ecls), dtype="float32")


def _ep_cfg(mod, cf: float, aux: bool = True):
    """Reduced deepseek-v2-236b at capacity factor ``cf``, its load-balance
    loss off unless ``aux``."""
    import dataclasses
    cfg = mod.reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf,
        aux_loss_coef=cfg.moe.aux_loss_coef if aux else 0.0))


LAYOUT_ARCHS = ("engram-27b", "deepseek-7b", "jamba-1.5-large-398b",
                "xlstm-125m")


def _layout_cfg(arch: str, port: bool = True):
    """torch_multidev_ref.layout_cfg's config, the port's or the
    reference's: reduced ``arch``, its vocabulary rounded up to a multiple
    of 4, with MoE a capacity factor at which nothing drops."""
    import dataclasses
    if port:
        from repro_torch.launch.train import reduced_config
    else:
        from repro.launch.train import reduced_config
    cfg = reduced_config(arch)
    cfg = dataclasses.replace(cfg, vocab_size=-(-cfg.vocab_size // 4) * 4)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def _inputs(d: Path):
    """The inputs: ``inputs.npz`` for the reference, ``inputs.pt`` for the
    ranks (the port's configs and tensors)."""
    from repro.configs import deepseek_v2_236b as ref_v2
    from repro.configs import deepseek_v3_671b as ref_v3
    from repro_torch.configs import deepseek_v2_236b
    rng = np.random.RandomState(0)
    ecfg = _engram_cfg(RefEngramConfig)
    n_tab = len(ecfg.orders) * ecfg.n_heads
    tables = rng.randn(n_tab, 4096, ecfg.emb_dim // ecfg.n_heads).astype(
        np.float32)
    toks = rng.randint(0, 101, (4, 8))
    npz = {"tables": tables,
           "idx": np.asarray(engram_indices(ecfg, toks)),
           "idx1": np.asarray(engram_indices(ecfg, toks[:1])),
           "idx_hot": np.asarray(engram_indices(
               ecfg, np.full((4, 8), 42, np.int32)))}
    rcfg = _moe_cfg(RefModelConfig, RefMoEConfig)
    mparams = jax.tree.map(np.asarray, ref_tree_init(
        ref_moe.moe_defs(rcfg, "float32"), 0))
    for k, v in mparams.items():
        if k == "shared":
            npz.update({f"moe/shared/{n}": a for n, a in v.items()})
        else:
            npz[f"moe/{k}"] = v
    npz["x"] = (rng.randn(2, 32, 32) * 0.3).astype(np.float32)
    npz["x_odd"] = (rng.randn(2, 6, 32) * 0.3).astype(np.float32)
    npz["embed_w"] = rng.randn(4096, 64).astype(np.float32)
    npz["embed_toks"] = rng.randint(0, 4096, (4, 8))
    cfg = _model_cfg(deepseek_v3_671b)
    npz["model_toks"] = rng.randint(1, cfg.vocab_size, (4, 8))
    npz["embed_cot"] = rng.randn(4, 8, 64).astype(np.float32)
    for arch in LAYOUT_ARCHS:
        npz[f"layout_toks/{arch}"] = rng.randint(
            1, _layout_cfg(arch).vocab_size, (4, 8))
    np.savez(d / "inputs.npz", **npz)
    rparams = ref_model.init_params(_model_cfg(ref_v3), 0)
    t = lambda a: to_torch(a, "cpu")                       # noqa: E731
    port = {k: t(v) for k, v in npz.items() if not k.startswith("moe/")}
    port.update(
        ecfg=_engram_cfg(EngramConfig), moe_cfg=_moe_cfg(ModelConfig,
                                                         MoEConfig),
        moe_params=tree_map(t, mparams), model_cfg=cfg,
        ddp_cfg=_ddp_cfg(ModelConfig, EngramConfig),
        ddp_params=from_jax(jax.tree.map(np.asarray, ref_model.init_params(
            _ddp_cfg(RefModelConfig, RefEngramConfig), 0)),
            _ddp_cfg(ModelConfig, EngramConfig), "cpu"),
        model_params=from_jax(jax.tree.map(np.asarray, rparams), cfg, "cpu"),
        decode_steps=DECODE_STEPS,
        tr_cfg=_tr_cfg(ModelConfig, EngramConfig),
        tr_params=from_jax(jax.tree.map(np.asarray, ref_model.init_params(
            _tr_cfg(RefModelConfig, RefEngramConfig), 0)),
            _tr_cfg(ModelConfig, EngramConfig), "cpu"),
        ep_cfg=_ep_cfg(deepseek_v2_236b, EP_CAPACITY),
        ep_cfg_raised=_ep_cfg(deepseek_v2_236b, 8.0, aux=False),
        ep_params=from_jax(jax.tree.map(np.asarray, ref_model.init_params(
            _ep_cfg(ref_v2, EP_CAPACITY), 0)),
            _ep_cfg(deepseek_v2_236b, EP_CAPACITY), "cpu"),
        layout_archs=LAYOUT_ARCHS)
    for arch in LAYOUT_ARCHS:
        port[f"layout_cfg/{arch}"] = _layout_cfg(arch)
        port[f"layout_params/{arch}"] = from_jax(jax.tree.map(
            np.asarray, ref_model.init_params(_layout_cfg(arch, False), 0)),
            _layout_cfg(arch), "cpu")
    torch.save(port, d / "inputs.pt")


def _run_ranks(d: Path, deadline: float) -> None:
    ctx = mp.start_processes(
        rank_main, args=(WORLD, f"file://{d / 'rdzv'}", str(d / "inputs.pt"),
                         str(d)),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks not done after {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, every rank's outputs)."""
    d = tmp_path_factory.mktemp("multidev")
    _inputs(d)
    deadline = time.monotonic() + TIMEOUT_S
    # the reference's train steps in a second subprocess, beside the rest
    refs = {part: subprocess.Popen(
        [sys.executable, str(HERE / "torch_multidev_ref.py"),
         str(d / "inputs.npz"), str(d / f"ref_{part}.npz"), part],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
        for part in ("mesh", "train", "layout")}
    try:
        _run_ranks(d, deadline)
        for ref in refs.values():
            _, err = ref.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert ref.returncode == 0, err[-4000:]
    finally:
        for ref in refs.values():
            if ref.poll() is None:
                ref.kill()
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]
    out = {}
    for part in refs:
        out.update(np.load(d / f"ref_{part}.npz"))
    return out, ranks


def _whole(ranks, key, split=None, batch_split=True):
    """The whole array from the ranks' blocks. The ranks of a data group
    hold the same batch rows (bit-equal), or with ``split`` each its model
    coordinate's block along that dim; the data groups' rows are
    concatenated, or, for a batch the data axis does not divide
    (``batch_split=False``), are the same whole batch."""
    (n_data, _), _ = MESH
    rows = []
    for di in range(n_data):
        mine = sorted((r for r in ranks if r["coords"][0] == di),
                      key=lambda r: int(r["coords"][1]))
        if split is None:
            for r in mine[1:]:
                assert torch.equal(r[key], mine[0][key]), key
            rows.append(mine[0][key])
        else:
            rows.append(torch.cat([r[key] for r in mine], dim=split))
    if not batch_split:
        for r in rows[1:]:
            assert torch.equal(r, rows[0]), key
        return rows[0].numpy()
    return torch.cat(rows).numpy()


@pytest.mark.parametrize("case", ["idx", "idx1", "idx_hot"])
@pytest.mark.parametrize("strategy", ["tp", "pooled"])
def test_engram_strategy_matches_reference(runs, strategy, case):
    """The rows gathered on the ranks equal the reference's same strategy
    and its local gather, bit for bit (f32); B = 1 (``idx1``) is whole on
    every rank of a data group; every request on one n-gram (``idx_hot``)
    is fetched once per rank and fanned out."""
    ref, ranks = runs
    got = _whole(ranks, f"{strategy}/{case}",
                 split=2 if strategy == "tp" else None,
                 batch_split=case != "idx1")
    np.testing.assert_array_equal(got, ref[f"{strategy}/{case}"])
    np.testing.assert_array_equal(got, ref[f"local/{case}"])
    assert np.abs(got).sum() > 0


def test_pooled_overflow_drops_the_reference_rows(runs):
    """At slack 0.25 each owner takes ceil(R / 8 / 4) of a rank's R
    requests: the rest come back as zero rows, the same ones as in the
    reference."""
    ref, ranks = runs
    got = _whole(ranks, "pooled_slack/idx")
    np.testing.assert_array_equal(got, ref["pooled_slack/idx"])
    per_table = lambda a: a.reshape(*a.shape[:2], -1, 16)    # noqa: E731
    dropped = ~per_table(got).any(axis=-1)
    assert dropped.any() and not (~per_table(ref["local/idx"]).any(-1)).any()


def test_pooled_reads_whole_tables_in_their_block(runs):
    ref, ranks = runs
    np.testing.assert_array_equal(_whole(ranks, "pooled_whole/idx"),
                                  ref["pooled/idx"])


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("strategy", ["gather", "alltoall"])
def test_moe_ep_matches_reference(runs, strategy, cf):
    """Expert-parallel MoE against the reference's same strategy and
    capacity factor; at 1.0 rows are dropped (the reference's output then
    leaves the dense one)."""
    ref, ranks = runs
    got = _whole(ranks, f"moe/{strategy}/{cf}/x")
    want = ref[f"moe/{strategy}/{cf}/x"]
    np.testing.assert_allclose(got, want, **MOE_TOL)
    np.testing.assert_allclose(
        float(ranks[0][f"moe_aux/{strategy}/{cf}/x"]),
        float(ref[f"moe_aux/{strategy}/{cf}/x"]), rtol=0, atol=1e-6)
    dense = ref[f"moe/dense/{cf}/x"]
    if cf == 8.0:
        np.testing.assert_allclose(got, dense, **MOE_TOL)
    else:
        assert not np.allclose(want, dense, **MOE_TOL)


def test_alltoall_odd_sequence_takes_the_gather_route(runs):
    """S = 6 is not a multiple of the 4-way expert axis: alltoall runs
    gather, as in the reference."""
    ref, ranks = runs
    for cf in CAPACITY_FACTORS:
        got = _whole(ranks, f"moe/alltoall/{cf}/x_odd")
        np.testing.assert_array_equal(
            got, _whole(ranks, f"moe/gather/{cf}/x_odd"))
        np.testing.assert_allclose(got, ref[f"moe/alltoall/{cf}/x_odd"],
                                   **MOE_TOL)


@pytest.mark.parametrize("held", ["block", "whole"])
def test_embed_lookup_local_matches_reference(runs, held):
    ref, ranks = runs
    np.testing.assert_array_equal(_whole(ranks, f"embed/{held}"),
                                  ref["embed"])


def test_deepseek_v3_mesh_forward_matches_single_device(runs):
    """Reduced deepseek-v3-671b under the mesh with tp retrieval (exact: no
    capacity), alltoall for the 8-token prefill and gather for the 1-token
    decode steps, the vocab-sharded embedding (its fallback: 509 rows do
    not divide over 4) against the reference on one device (local,
    ragged)."""
    ref, ranks = runs
    got = _whole(ranks, "model/tp")
    want = ref["model/local"]
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_deepseek_v3_pooled_mesh_forward_matches_reference_mesh(runs):
    """The same with pooled retrieval, against the reference's forward
    under the same mesh and flags. Its hashes reach rows [0, 2048) of
    4096 padded rows, i.e. 4 of the 8 owners, whose capacity (slack 2.0
    over 8 owners) then overflows: both packages drop the same requests,
    and both part from the single-device logits (ROADMAP F13)."""
    ref, ranks = runs
    got = _whole(ranks, "model/pooled")
    want = ref["model/pooled"]
    np.testing.assert_allclose(got, want, **LOGITS_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert not np.allclose(want, ref["model/local"], **LOGITS_TOL)


# ------------------------------------------------- training on the mesh

DDP_TOL = dict(rtol=0.2, atol=5e-3)          # check_compressed_ddp's
GRAD_ACCUM_TOL = dict(rtol=5e-3, atol=1e-4)  # tests/test_train_loop.py's


def _ref_ddp(ref, name):
    """The reference's one-step DDP parameters, in the port's layout."""
    rparams = ref_model.init_params(_ddp_cfg(RefModelConfig,
                                             RefEngramConfig), 0)
    leaves, treedef = jax.tree.flatten(rparams)
    tree = jax.tree.unflatten(treedef, [ref[f"ddp/{name}/p{i}"]
                                        for i in range(len(leaves))])
    return {k: v.numpy() for k, v in tree_paths(from_jax(
        tree, _ddp_cfg(ModelConfig, EngramConfig), "cpu"))}


def test_compressed_ddp_matches_exact_and_reference(runs):
    """check_compressed_ddp's twin on 8 gloo ranks: the int8-wire step
    within quantisation tolerance of the exact one, both within the
    reference's grad-accumulation tolerance of the reference's same step,
    the replicas equal, the loss the reference's."""
    ref, ranks = runs
    for name in ("compress", "exact"):
        want = _ref_ddp(ref, name)
        for r in ranks:
            assert r[f"ddp/{name}/params"].keys() == want.keys()
            for k, v in r[f"ddp/{name}/params"].items():
                assert torch.equal(v, ranks[0][f"ddp/{name}/params"][k]), k
                np.testing.assert_allclose(v.numpy(), want[k], err_msg=k,
                                           **GRAD_ACCUM_TOL)
            np.testing.assert_allclose(float(r[f"ddp/{name}/loss"]),
                                       float(ref[f"ddp/{name}/loss"]),
                                       rtol=1e-5)
    for k, v in ranks[0]["ddp/compress/params"].items():
        np.testing.assert_allclose(v.numpy(),
                                   ranks[0]["ddp/exact/params"][k].numpy(),
                                   err_msg=k, **DDP_TOL)


def test_compressed_ddp_wire_is_int8(runs):
    """Both wire passes carried int8 (the reference reads ``s8[`` in its
    HLO), once per gradient leaf; the exact step used neither."""
    _, ranks = runs
    n_leaves = len(ranks[0]["ddp/exact/params"])
    for r in ranks:
        assert r["ddp/compress/wire"] == {
            ("all_to_all", "torch.int8"): n_leaves,
            ("all_gather", "torch.int8"): n_leaves}
        assert r["ddp/exact/wire"] == {}


def test_compressed_ddp_loss_decreases(runs):
    _, ranks = runs
    losses = ranks[0]["ddp/losses"]
    assert len(losses) == 8 and losses[-1] < losses[0], losses
    for r in ranks[1:]:
        assert torch.equal(r["ddp/losses"], losses)


def test_elastic_checkpoint_relayout(runs):
    """check_elastic_checkpoint's twin: saved from an (8,) mesh whose ranks
    held row blocks, restored onto a (2, 4) ("x", "y") mesh, each rank its
    block; the blocks make the whole leaves again."""
    _, ranks = runs
    w = torch.arange(64.0).reshape(8, 8)
    seen = set()
    for r in ranks:
        x, y = (int(c) for c in r["elastic/coords"])
        seen.add((x, y))
        assert torch.equal(r["elastic/w"],
                           w[y * 2:(y + 1) * 2, x * 4:(x + 1) * 4])
        assert torch.equal(r["elastic/b"], torch.ones(2))
    assert len(seen) == 8


# ------------------------------------------ gradients through the mesh

from torch_multidev_ranks import (COLL_CASES, TRAIN_LR,  # noqa: E402
                                  coll_draw, coll_out_shape)

GRAD_FLOOR = 1e-4        # tests/test_torch_train.py's gradient share
ADAMW_TOL = dict(rtol=1e-6)   # and its AdamW tolerance (of a leaf's scale)


def _whole_collective(name, xs, axes):
    """Collective ``name`` computed whole on one process: ``xs`` holds
    every rank's input (rank order), the result every rank's output."""
    (n_data, n_model), _ = MESH
    if axes == ("model",):
        groups = [list(range(g * n_model, (g + 1) * n_model))
                  for g in range(n_data)]
    else:
        groups = [list(range(WORLD))]
    out = [None] * WORLD
    for grp in groups:
        x = [xs[r] for r in grp]
        n = len(grp)
        for i, r in enumerate(grp):
            if name == "all_to_all":
                out[r] = torch.stack([x[j][i] for j in range(n)])
            elif name == "psum":
                out[r] = sum(x)
            elif name == "pmean":
                out[r] = sum(x) / n
            elif name == "psum_scatter":
                k = x[0].shape[1] // n
                out[r] = sum(x)[:, i * k:(i + 1) * k]
            elif name == "all_gather":
                out[r] = torch.stack(x)
            else:
                out[r] = torch.cat(x, dim=1)
    return out


@pytest.mark.parametrize("case", range(len(COLL_CASES)),
                         ids=[c[0] for c in COLL_CASES])
def test_collective_gradient_is_its_transpose(runs, case):
    """Each rank's gradient of <collective(x_r), c_r> through the
    collective's backward equals the gradient of the sum over ranks of the
    same, computed whole on one process in f64: the backward is the
    collective's transpose over the ranks."""
    _, ranks = runs
    name, axes, shape = COLL_CASES[case]
    n = 4 if axes == ("model",) else WORLD
    draws = [coll_draw(r, case, shape, coll_out_shape(name, n, shape))
             for r in range(WORLD)]
    xs = [x.clone().requires_grad_() for x, _ in draws]
    ys = _whole_collective(name, xs, axes)
    total = sum((y * c).sum() for y, (_, c) in zip(ys, draws))
    want = torch.autograd.grad(total, xs)
    for r in ranks:
        rank = int(r["coords"][0]) * 4 + int(r["coords"][1])
        torch.testing.assert_close(r[f"coll/{name}"], want[rank], rtol=1e-12,
                                   atol=1e-12)


def test_embed_lookup_local_gradient_matches_whole_table(runs):
    """The vocab-sharded embedding's table gradient (each rank's rows
    back-propagated through ``psum``'s transpose, then summed over the
    data axis) equals the whole table's gradient of the mean over the two
    data groups' rows: equal on every rank, bit for bit up to the order of
    the sums."""
    _, ranks = runs
    inp = np.load(os.path.join(ranks[0]["out_dir"], "inputs.npz"))
    w = torch.from_numpy(inp["embed_w"]).requires_grad_()
    toks = torch.from_numpy(inp["embed_toks"])
    cot = torch.from_numpy(inp["embed_cot"])
    (want,) = torch.autograd.grad((w[toks] * cot).sum() / 2, w)
    assert want.abs().max() > 0
    for r in ranks:
        torch.testing.assert_close(r["embed_grad"], want, rtol=1e-6,
                                   atol=1e-6)


def _ref_tree(ref, key, cfg_pair, leaf="g"):
    """The reference's ``key`` leaves (``{key}/{leaf}{i}``) in the port's
    layout, by path."""
    rcfg, cfg = cfg_pair
    leaves, treedef = jax.tree.flatten(ref_model.init_params(rcfg, 0))
    tree = jax.tree.unflatten(treedef, [ref[f"{key}/{leaf}{i}"]
                                        for i in range(len(leaves))])
    return {k: v.numpy() for k, v in tree_paths(from_jax(tree, cfg, "cpu"))}


def _grad_share(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k].numpy() - w).max()
                     / max(float(np.abs(w).max()), 1e-30))
               for k, w in want.items())


def _replicas_equal(ranks, key):
    """Every rank holds the same whole leaves under ``key``; rank 0's."""
    for r in ranks[1:]:
        for k, v in r[key].items():
            assert torch.equal(v, ranks[0][key][k]), (key, k)
    return ranks[0][key]


def _tr_pair():
    return (_tr_cfg(RefModelConfig, RefEngramConfig),
            _tr_cfg(ModelConfig, EngramConfig))


def _ep_pair(cf=EP_CAPACITY, aux=True):
    from repro.configs import deepseek_v2_236b as ref_v2
    from repro_torch.configs import deepseek_v2_236b
    return (_ep_cfg(ref_v2, cf, aux), _ep_cfg(deepseek_v2_236b, cf, aux))


@pytest.mark.parametrize("against", ["mesh", "one"])
@pytest.mark.parametrize("strategy", ["pooled", "tp"])
def test_train_step_loss_matches_reference(runs, strategy, against):
    """check_tp_train_step's twin: the global mean loss on a (2, 4) mesh
    within rtol 1e-4 of the reference's mesh loss and its one-device
    loss, the same on every rank, for both the gradient pass and the
    step."""
    ref, ranks = runs
    want = float(ref[f"tr/{strategy if against == 'mesh' else 'one'}/loss"])
    for r in ranks:
        for key in ("loss", "step_loss"):
            np.testing.assert_allclose(float(r[f"tr/{strategy}/{key}"]), want,
                                       rtol=1e-4)
        assert float(r[f"tr/{strategy}/loss"]) == \
            float(ranks[0][f"tr/{strategy}/loss"])


@pytest.mark.parametrize("against", ["mesh", "one"])
@pytest.mark.parametrize("strategy", ["pooled", "tp"])
def test_train_step_gradients_match_reference(runs, strategy, against):
    """Every leaf's gradient, blocks gathered, within max(1e-4, the
    reference's largest one-ulp witness) of that leaf's largest, against
    the reference's mesh and its one-device gradients; the tables'
    nonzero."""
    ref, ranks = runs
    name = f"tr/{strategy if against == 'mesh' else 'one'}"
    got = _replicas_equal(ranks, f"tr/{strategy}/grads")
    want = _ref_tree(ref, name, _tr_pair())
    limit = max(GRAD_FLOOR, float(ref[f"{name}/wit_g"].max()))
    share = _grad_share(got, want)
    print(f"{strategy} against {against}: {share:.2e} of a leaf's largest "
          f"(limit {limit:.2e})")
    assert share <= limit
    assert got["engram/layers/0/tables"].abs().max() > 0


@pytest.mark.parametrize("against", ["mesh", "one"])
@pytest.mark.parametrize("strategy", ["pooled", "tp"])
def test_train_step_adamw_matches_reference(runs, strategy, against):
    """One AdamW step at lr 1e-4: grad_norm, taken over the blocks, and the
    parameters, gathered, against the reference's, at tests/
    test_torch_train.py's AdamW tolerance (1e-6, of a leaf's largest for
    the parameters) or, where the reference's own grad_norm and stepped
    parameters move further when its weights move by about one ulp, the
    largest such move (the gradients they start from part by the
    gradient witnesses). Its grad_norm exceeds grad_clip, so the clipping
    binds on that norm."""
    ref, ranks = runs
    name = f"tr/{strategy if against == 'mesh' else 'one'}"
    want_n = float(ref[f"{name}/gnorm"])
    assert want_n > 1.0                               # AdamWConfig.grad_clip
    n_lim = max(ADAMW_TOL["rtol"], float(ref[f"{name}/wit_gnorm"].max()))
    p_lim = max(ADAMW_TOL["rtol"], float(ref[f"{name}/wit_p"].max()))
    print(f"{strategy} against {against}: grad_norm "
          f"{abs(float(ranks[0][f'tr/{strategy}/gnorm']) - want_n) / want_n:.2e}"
          f" (limit {n_lim:.2e}), parameters (limit {p_lim:.2e})")
    for r in ranks:
        np.testing.assert_allclose(float(r[f"tr/{strategy}/gnorm"]), want_n,
                                   rtol=n_lim)
    got = _replicas_equal(ranks, f"tr/{strategy}/params")
    want = _ref_tree(ref, name, _tr_pair(), leaf="p")
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=k,
                                   atol=p_lim * np.abs(w).max(), **ADAMW_TOL)


@pytest.mark.parametrize("strategy", ["gather", "alltoall"])
def test_ep_train_step_matches_reference_mesh(runs, strategy):
    """Reduced deepseek-v2-236b's expert-parallel step at its capacity
    factor 1.25, where the mesh drops rows: the loss within rtol 1e-4 and
    every gradient within 1e-4 of its leaf's largest (the fixed share; no
    witness is drawn) of the reference's mesh step, drops included."""
    ref, ranks = runs
    name = f"ep/{strategy}"
    for r in ranks:
        np.testing.assert_allclose(float(r[f"ep_cfg/{strategy}/loss"]),
                                   float(ref[f"{name}/loss"]), rtol=1e-4)
    got = _replicas_equal(ranks, f"ep_cfg/{strategy}/grads")
    share = _grad_share(got, _ref_tree(ref, name, _ep_pair()))
    print(f"ep {strategy} at 1.25: {share:.2e} (limit {GRAD_FLOOR:.0e})")
    assert share <= GRAD_FLOOR


@pytest.mark.parametrize("strategy", ["gather", "alltoall"])
def test_ep_train_step_without_drops_matches_one_device(runs, strategy):
    """With the capacity raised (8.0, nothing drops) and the load-balance
    loss off (a mean over token groups is not the whole batch's), the
    mesh step is the one-device (ragged) step: loss within rtol 1e-4,
    every gradient within 1e-4 of its leaf's largest."""
    ref, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(
            float(r[f"ep_cfg_raised/{strategy}/loss"]),
            float(ref["ep/one/loss"]), rtol=1e-4)
    got = _replicas_equal(ranks, f"ep_cfg_raised/{strategy}/grads")
    share = _grad_share(got, _ref_tree(ref, "ep/one", _ep_pair(8.0, False)))
    print(f"ep {strategy} raised: {share:.2e} (limit {GRAD_FLOOR:.0e})")
    assert share <= GRAD_FLOOR


def test_remat_backward_on_another_thread(runs):
    """A checkpointed period recomputed in backward on a thread without
    the mesh's context (as the autograd engine's CUDA thread is) runs the
    expert-parallel path it ran forward: its gradients bit-equal to the
    same backward on the forward's thread, on every rank."""
    _, ranks = runs
    for r in ranks:
        assert r["remat_thread"] and all(
            x is True for x in r["remat_thread"]), r["remat_thread"]


def test_mesh_trainer_restart_is_bit_equal(runs, tmp_path_factory):
    """The mesh trainer crashed after step 3 restarts from step 2's
    checkpoint: its last two losses and its final checkpoint bit-equal to
    the uninterrupted mesh run's, on every rank."""
    _, ranks = runs
    from repro_torch.checkpoint import Checkpointer
    for r in ranks:
        assert r["trainer/restarts"] == 1
        assert torch.equal(r["trainer/crash"], r["trainer/whole"][2:])
        assert torch.equal(r["trainer/whole"], ranks[0]["trainer/whole"])
    d = ranks[0]["out_dir"]
    cfg = _tr_cfg(ModelConfig, EngramConfig)
    from repro_torch.models.model import abstract_params
    from repro_torch.train import abstract_opt_state
    ab = abstract_params(cfg)
    like = {"params": ab, "opt": abstract_opt_state(ab)}
    got = [Checkpointer(os.path.join(d, n)).restore(4, like, "cpu")
           for n in ("crash", "whole")]
    for (k, a), (_, b) in zip(tree_paths(got[0]), tree_paths(got[1])):
        assert torch.equal(a, b), k


def test_mesh_checkpoint_restores_onto_another_mesh(runs):
    """The checkpoint the (2, 4) mesh wrote (whole leaves, rank 0) restores
    onto an (8,) mesh: each rank its block of the pooled tables (rows over
    the 8 ranks), the dense leaves whole."""
    _, ranks = runs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.model import abstract_params
    from repro_torch.train import abstract_opt_state
    cfg = _tr_cfg(ModelConfig, EngramConfig)
    ab = abstract_params(cfg)
    whole = Checkpointer(os.path.join(ranks[0]["out_dir"], "crash")).restore(
        4, {"params": ab, "opt": abstract_opt_state(ab)}, "cpu")["params"]
    tab = whole["engram"]["layers"][0]["tables"]
    n = tab.shape[1] // WORLD
    seen = set()
    for r in ranks:
        i = r["trainer/index8"]
        seen.add(i)
        got = r["trainer/restored8"]
        assert torch.equal(got["engram"]["layers"][0]["tables"],
                           tab[:, i * n:(i + 1) * n])
        assert torch.equal(got["final_norm"]["scale"],
                           whole["final_norm"]["scale"])
    assert seen == set(range(WORLD))


def test_cli_trains_on_a_two_rank_mesh(runs):
    """``launch.train.main(..., init_method=file://...)`` with ``--mesh
    data=1,model=2 --engram tp --device cpu`` on ranks 0 and 1: rank 0
    writes the metrics; the losses are the one-process run's (tp
    retrieval reads every row exactly)."""
    import json
    _, ranks = runs
    from repro_torch.configs import engram_27b
    from repro_torch.data import DataConfig
    from repro_torch.models.transformer import RunFlags
    from repro_torch.train import AdamWConfig, TrainConfig, train
    m = json.loads(open(os.path.join(ranks[0]["out_dir"],
                                     "cli.json")).read())
    assert m["final_step"] == 2 and len(m["losses"]) == 2
    cfg = engram_27b.reduced()
    one = train(cfg, TrainConfig(steps=2, log_every=10, ckpt_every=50),
                DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=16,
                           seed=0),
                flags=RunFlags(remat=True, engram_strategy="tp"),
                oc=AdamWConfig(lr=3e-4, warmup_steps=1, decay_steps=2),
                log=lambda s: None, device="cpu")
    np.testing.assert_allclose(m["losses"], one.losses, rtol=1e-5)


# ------------------------------------------- the reference's mesh layout

# the layout forwards' tolerances: LOGITS_TOL, and through a recurrent
# stack ROADMAP's recurrent rule, relative to the largest logit (1e-4 for
# jamba, 2e-3 for xLSTM, whose gates carry states up to 2e5)
RECURRENT_TOL = {"jamba-1.5-large-398b": 1e-4, "xlstm-125m": 2e-3}


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_layout_forward_matches_reference_mesh(runs, arch):
    """Reduced dense GQA (engram-27b: its KV heads whole over the model
    axis, deepseek-7b: split), jamba and xLSTM, each rank on its blocks of
    the reference's layout (heads, KV heads, ffn and the vocabulary split
    over the model axis, pooled tables, alltoall MoE): prefill and greedy
    decode against the reference's forward under the same mesh and flags,
    logits within the files' tolerance, the same greedy tokens."""
    ref, ranks = runs
    got = _whole(ranks, f"layout/{arch}")
    want = ref[f"layout/{arch}"]
    top = float(np.abs(want).max())
    tol = LOGITS_TOL if arch not in RECURRENT_TOL else dict(
        rtol=RECURRENT_TOL[arch], atol=RECURRENT_TOL[arch] * max(1.0, top))
    print(f"{arch}: {np.abs(got - want).max() / top:.2e} of the largest "
          "logit")
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _rank_ctx(r):
    from repro_torch.sharding import rules
    (shape, axes) = MESH
    return rules.ShardCtx(rules.Mesh.of(shape, axes, coords={
        a: int(c) for a, c in zip(axes, r["coords"])}),
        dict(rules.DEFAULT_RULES))


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_layout_blocks_are_the_reference_shard_shapes(runs, arch):
    """Every rank's parameter blocks have the shapes of ``specs.
    param_shardings`` under the reference's axes (tests/
    test_torch_dryrun.py holds those equal to the reference's
    ``NamedSharding.shard_shape``), but for the leaves of
    ``whole_leaves``, which it holds whole; its decode state's blocks
    after the prefill are ``specs.state_shardings``' of the whole state;
    its blocks gather back into the whole leaves (``gather_block``, as a
    checkpoint saves them: jamba's and xLSTM's fused leaves part by
    part)."""
    from repro_torch.launch import specs
    from repro_torch.models.model import abstract_params, whole_leaves
    from repro_torch.models.transformer import RunFlags
    _, ranks = runs
    cfg = _layout_cfg(arch)
    whole = dict(tree_paths(abstract_params(cfg)))
    state = specs.abstract_decode_state(cfg, RunFlags(), 4,
                                        8 + DECODE_STEPS, device="meta")
    for r in ranks:
        ctx = _rank_ctx(r)
        held = whole_leaves(cfg, ctx)
        want = dict(tree_paths(specs.param_shardings(cfg, ctx),
                               is_leaf=lambda x: isinstance(x, tuple)))
        got = r[f"layout_params/{arch}"]
        assert got.keys() == want.keys()
        assert held and all(got[k] == tuple(whole[k].shape) for k in held)
        assert {k: v for k, v in got.items() if k not in held} == {
            k: v for k, v in want.items() if k not in held}
        assert any(got[k] != tuple(t.shape) for k, t in whole.items())
        want_state = dict(tree_paths(specs.state_shardings(state, ctx),
                                     is_leaf=lambda x: isinstance(x, tuple)))
        assert r[f"layout_state/{arch}"] == want_state
        assert r[f"layout_gather/{arch}"] == []


@pytest.mark.parametrize("against", ["mesh", "one"])
@pytest.mark.parametrize("strategy", ["pooled", "tp"])
def test_train_step_moments_match_reference(runs, strategy, against):
    """ZeRO-1's moments after one AdamW step, each rank's slices gathered
    whole: the first moment within the gradients' rule (max(1e-4, the
    reference's largest one-ulp witness) of a leaf's largest), the second
    (the gradient squared) within twice it, against the reference's mesh
    and one-device moments."""
    ref, ranks = runs
    name = f"tr/{strategy if against == 'mesh' else 'one'}"
    limit = max(GRAD_FLOOR, float(ref[f"{name}/wit_g"].max()))
    for mom, lim in (("m", limit), ("v", 2 * limit)):
        got = _replicas_equal(ranks, f"tr/{strategy}/{mom}")
        share = _grad_share(got, _ref_tree(ref, name, _tr_pair(), leaf=mom))
        print(f"{strategy} {mom} against {against}: {share:.2e} "
              f"(limit {lim:.2e})")
        assert share <= lim


@pytest.mark.parametrize("strategy", ["pooled", "tp"])
def test_train_step_moment_blocks_are_zero1(runs, strategy):
    """Each rank holds its ZeRO-1 slice of every moment: the shape of the
    reference's ``opt_state_axes`` layout (the "opt" axis over "data" on
    the first dim the parameter keeps whole), split further than the
    parameter's block for some leaves."""
    from repro_torch.models.model import (abstract_params,
                                          train_logical_axes)
    from repro_torch.models.transformer import RunFlags
    from repro_torch.train import opt_state_axes
    _, ranks = runs
    cfg = _tr_cfg(ModelConfig, EngramConfig)
    axes = train_logical_axes(cfg, RunFlags(engram_strategy=strategy))
    is_axes = lambda x: isinstance(x, tuple)                  # noqa: E731
    mom = dict(tree_paths(opt_state_axes(axes)["m"], is_leaf=is_axes))
    par = dict(tree_paths(axes, is_leaf=is_axes))
    whole = dict(tree_paths(abstract_params(cfg)))
    for r in ranks:
        ctx = _rank_ctx(r)
        want = {k: ctx.block_shape(tuple(t.shape), mom[k])
                for k, t in whole.items()}
        for m in ("m", "v"):
            assert r[f"tr/{strategy}/{m}_shapes"] == want
        assert any(want[k] != ctx.block_shape(tuple(t.shape), par[k])
                   for k, t in whole.items())
