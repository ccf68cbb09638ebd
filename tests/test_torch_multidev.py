"""PyTorch port vs the JAX reference: the mesh paths on a (2, 4)
("data", "model") mesh, on the CPU.

The reference runs in one subprocess with 8 fake host devices
(tests/torch_multidev_ref.py; the pytest process stays at 1 device). The
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


def _inputs(d: Path):
    """The inputs: ``inputs.npz`` for the reference, ``inputs.pt`` for the
    ranks (the port's configs and tensors)."""
    from repro.configs import deepseek_v3_671b as ref_v3
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
        decode_steps=DECODE_STEPS)
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
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "torch_multidev_ref.py"),
         str(d / "inputs.npz"), str(d / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        _run_ranks(d, deadline)
        _, err = ref.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(WORLD)]
    return dict(np.load(d / "ref.npz")), ranks


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
