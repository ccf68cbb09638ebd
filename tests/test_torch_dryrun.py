"""PyTorch port vs the JAX reference: the dry-run tooling
(``repro_torch.launch.specs``, ``launch.dryrun``, ``roofline.report``,
``examples.multipod_dryrun``), on the CPU.

* ``input_specs`` and ``abstract_decode_state`` against the reference's
  ``ShapeDtypeStruct``s leaf by leaf, for every arch x applicable shape
  (the reference's stacked cache leaves unstacked to the port's per-layer
  caches, their layer axis dropped).
* The rank's block shapes of the parameters, the batch and the decode
  state on a (2, 4) mesh against the reference's ``NamedSharding.
  shard_shape`` for the same logical axes (on a ``jax.sharding.
  AbstractMesh``: no devices needed), for every arch x shape, full and
  reduced, the decode state also under ``cell_rules``' ``kv_seq`` (over
  "data" for long_500k, over "model" with ``--optimized``), where a rank's
  ``init_decode_state`` under ``effective_rules`` makes the same blocks;
  the blocks a rank holds (``local_params``, ZeRO-1's moments,
  ``init_decode_state``) against the same, for every reduced arch;
  ``cell_rules`` against the reference's rule.
* One subprocess (``tests/torch_dryrun_cells.py``, a fake world of 256
  and 512 ranks): a full-width cell (gemma3-1b x decode_32k) on the meta
  device, on the CPU path, with ``unroll`` and on the multi-pod mesh,
  reduced deepseek-v2's train and decode steps under expert parallelism;
  every record ``ok`` with the reference's keys less ``NO_COUNTERPART``;
  ``unroll`` changes no count; the collectives the counting mode records
  from c10d calls equal the reference's ``collective_stats`` of
  tests/test_roofline.py's HLO; the report renders; ``zero1`` is
  recorded and changes no count; the kernels appear by name on the
  card's path and not on the CPU path; ``unmirrored`` is empty in every
  record; reduced jamba's long_500k cell through the hillclimb driver
  with and without ``kv_seq`` (KV blocks 1/16 of the sequence, the
  combine's collectives).
* The hillclimb twin's ``parse_flags`` against the reference's.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.launch.train import reduced_config as ref_reduced  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro.models.transformer import segment_plan as ref_plan  # noqa: E402
from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro.sharding import rules as ref_rules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.train import reduced_config  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.params import tree_paths  # noqa: E402
from repro_torch.models.transformer import RunFlags  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

ARCH_SHAPES = [(a, s) for a in ref_base.list_archs()
               for s in ref_base.applicable_shapes(ref_base.get_config(a))]
IDS = [f"{a}-{s}" for a, s in ARCH_SHAPES]

# the reference's dry-run record keys (repro/launch/dryrun.py, a cell
# that compiled), nested ones as "outer.inner"
REF_KEYS = {"version", "arch", "shape", "mesh", "axes", "n_devices",
            "unroll", "moe", "engram_strategy", "params", "active_params",
            "optimized", "rules", "lower_s", "compile_s", "memory",
            "cost", "collectives", "scaled", "hlo_chars", "model_flops",
            "ok", "total_s", "memory.argument_bytes", "memory.output_bytes",
            "memory.temp_bytes", "memory.alias_bytes",
            "memory.peak_bytes_est", "cost.flops", "cost.bytes_accessed",
            "cost.transcendentals"}


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _unstack_state(cfg, state):
    """The reference's decode state in the port's layout: each segment's
    caches a list in layer order, a stacked leaf once per layer with its
    leading layer axis dropped."""
    segs = []
    for seg, sc in zip(ref_plan(cfg), state["caches"]):
        blocks = list(sc["prefix"])
        for r in range(seg.n_periods):
            for pos in range(seg.period):
                blocks.append(jax.tree.map(
                    lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
                    sc["stack"][pos]))
        segs.append(blocks)
    return {**{k: v for k, v in state.items() if k != "caches"},
            "caches": segs}


def _leaves(tree):
    """(path, shape, dtype) of every leaf of a port tree."""
    return [(p, tuple(t.shape), _dtype(t)) for p, t in tree_paths(tree)]


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = []
    for path, a in flat:
        keys = []
        for k in path:
            keys.append(str(getattr(k, "key", getattr(k, "idx", k))))
        out.append(("/".join(keys), tuple(a.shape), str(a.dtype)))
    return out


@pytest.mark.parametrize("arch,shape", ARCH_SHAPES, ids=IDS)
def test_input_specs_match_reference(arch, shape):
    want = ref_specs.input_specs(ref_base.get_config(arch),
                                 ref_base.SHAPES[shape])
    got = specs.input_specs(configs.get_config(arch), configs.SHAPES[shape],
                            device="meta")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert _dtype(got[k]) == str(want[k].dtype), k
        assert got[k].device.type == "meta"
    fake = specs.input_specs(configs.get_config(arch), configs.SHAPES[shape],
                             device="cpu")
    assert all(type(v).__name__ == "FakeTensor" for v in fake.values())


@pytest.mark.parametrize("arch,shape", [x for x in ARCH_SHAPES
                                        if "decode" in x[1]
                                        or "long" in x[1]],
                         ids=[i for i in IDS if "decode" in i or "long" in i])
def test_abstract_decode_state_matches_reference(arch, shape):
    sh = ref_base.SHAPES[shape]
    rcfg = ref_base.get_config(arch)
    want = _unstack_state(rcfg, ref_specs.abstract_decode_state(
        rcfg, RefFlags(), sh.global_batch, sh.seq_len))
    got = specs.abstract_decode_state(configs.get_config(arch), RunFlags(),
                                      sh.global_batch, sh.seq_len,
                                      device="meta")
    assert _leaves(got) == _ref_leaves(want)


def _ctxs(extra=None):
    axes = ("data", "model")
    ref = ref_rules.ShardCtx(AbstractMesh((2, 4), axes),
                             {**ref_rules.DEFAULT_RULES, **(extra or {})})
    port = rules.ShardCtx(rules.Mesh.of((2, 4), axes),
                          {**rules.DEFAULT_RULES, **(extra or {})})
    return ref, port


def _shard_shapes(tree, shardings):
    return jax.tree.map(lambda a, s: s.shard_shape(a.shape), tree,
                        shardings)


def _unstack_params(cfg, tree):
    """The reference's parameter tree in the port's layout (as
    models.params.from_jax lays it out), of shape tuples."""
    is_shape = lambda x: isinstance(x, tuple)                # noqa: E731
    segs = []
    for seg, sp in zip(ref_plan(cfg), tree["segments"]):
        blocks = list(sp["prefix"])
        for _ in range(seg.n_periods):
            blocks += [jax.tree.map(lambda s: s[1:], b, is_leaf=is_shape)
                       for b in sp["stack"]]
        segs.append(blocks)
    return {**{k: v for k, v in tree.items() if k != "segments"},
            "segments": segs}


def _paths(tree):
    return tree_paths(tree, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch,shape", ARCH_SHAPES, ids=IDS)
def test_rank_blocks_match_reference_shard_shapes(arch, shape, size):
    rcfg = ref_base.get_config(arch) if size == "full" else ref_reduced(arch)
    cfg = configs.get_config(arch) if size == "full" else \
        reduced_config(arch)
    sh = ref_base.SHAPES[shape]
    ref, port = _ctxs()
    # parameters
    want = _unstack_params(rcfg, _shard_shapes(
        ref_model.abstract_params(rcfg), ref_specs.param_shardings(rcfg, ref)))
    assert _paths(specs.param_shardings(cfg, port)) == _paths(want)
    # the batch
    rsp = ref_specs.input_specs(rcfg, sh)
    want = {k: s.shard_shape(rsp[k].shape)
            for k, s in ref_specs.batch_shardings(rsp, ref).items()}
    got = specs.batch_shardings(specs.input_specs(
        cfg, configs.SHAPES[shape], device="meta"), port)
    assert got == want
    if sh.kind != "decode":
        return
    # the decode state, at a length the test keeps small, under the
    # default rules and under cell_rules' (kv_seq over "data" for a batch
    # that cannot fill it, over "model" with --optimized where the KV
    # heads cannot fill it); the blocks a rank's init_decode_state makes
    # under the rules the dry run applies (effective_rules) are the same
    B, S = sh.global_batch, 64
    rstate = ref_specs.abstract_decode_state(rcfg, RefFlags(), B, S)
    state = specs.abstract_decode_state(cfg, RunFlags(), B, S,
                                        device="meta")
    mesh = rules.Mesh.of((2, 4), ("data", "model"),
                         coords={"data": 1, "model": 3})
    seen = []
    for optimized in (False, True):
        extra = dryrun.cell_rules(cfg, sh, mesh, optimized)
        ref, port = _ctxs(extra)
        want = _unstack_state(rcfg, jax.tree.map(
            lambda a, s: jax.ShapeDtypeStruct(s.shard_shape(a.shape),
                                              a.dtype),
            rstate, ref_specs.state_shardings(rstate, ref)))
        got = specs.state_shardings(state, port)
        assert [(p, s) for p, s in _paths(got)] == [
            (p, s) for p, s, _ in _ref_leaves(want)]
        applied = dryrun.effective_rules(
            extra, mesh, dataclasses.replace(sh, seq_len=S))
        with rules.sharding_ctx(mesh, applied) as ctx:
            share = ctx.block_shape((B,), ("batch",))[0]
            blocks = port_model.init_decode_state(cfg, RunFlags(), share,
                                                  S, "meta")
        assert {p: tuple(t.shape) for p, t in tree_paths(blocks)} == dict(
            _paths(got))
        seen.append(extra.get("kv_seq"))
    if shape == "long_500k":
        assert seen == [("data",), ("data",)]


@pytest.mark.parametrize("arch,ref_splits_more", [
    ("deepseek-7b", True), ("jamba-1.5-large-398b", True),
    ("xlstm-125m", True), ("deepseek-v3-671b", False)])
def test_dryrun_state_is_split_on_batch_only(arch, ref_splits_more):
    """The port's decode state on the production mesh: the blocks a rank's
    ``init_decode_state`` makes under the mesh (its share of the batch)
    are the reference's layout, ``specs.state_shardings`` (held equal to
    the reference's ``shard_shape`` above): KV heads over "kv_heads",
    recurrent channels over "ffn" and heads over "heads", where the axes
    divide them; split further than the batch where the reference's is
    (MLA's latent caches have neither heads nor channels)."""
    cfg = configs.get_config(arch)
    state = specs.abstract_decode_state(cfg, RunFlags(), 128, 64,
                                        device="meta")
    mesh = rules.Mesh.of((16, 16), ("data", "model"),
                         coords={"data": 3, "model": 5})
    with rules.sharding_ctx(mesh) as ctx:
        blocks = port_model.init_decode_state(cfg, RunFlags(), 128 // 16,
                                              64, "meta")
    want = specs.state_shardings(state, ctx)
    got = {p: tuple(t.shape) for p, t in tree_paths(blocks)}
    assert got == dict(_paths(want))
    batch_only = {p: (t.shape[0] // 16,) + tuple(t.shape[1:])
                  for p, t in tree_paths(state)}
    assert (got != batch_only) == ref_splits_more


def _ref_moment_shapes(rcfg, ref):
    """The reference's ZeRO-1 moment blocks (``opt_state_axes`` placed on
    ``ref``'s mesh), in the port's layout."""
    from repro.train import optimizer as ref_opt
    is_axes = lambda x: isinstance(x, tuple) and all(     # noqa: E731
        a is None or isinstance(a, str) for a in x)
    axes = ref_opt.opt_state_axes(ref_model.params_logical_axes(rcfg))["m"]
    shapes = jax.tree.map(
        lambda ax, a: ref.sharding_for(a.shape, ax).shard_shape(a.shape),
        axes, ref_model.abstract_params(rcfg), is_leaf=is_axes)
    return _unstack_params(rcfg, shapes)


@pytest.mark.parametrize("arch", ref_base.list_archs())
def test_rank_layout_is_the_reference_layout(arch):
    """Reduced ``arch`` (its vocabulary a multiple of 4, so the model axis
    splits the embedding and the head) on each rank of a (2, 4) mesh: the
    parameter blocks ``local_params`` takes for the forward and for
    training (pooled tables) have the reference's ``shard_shape`` but for
    ``whole_leaves``, which are whole; the ZeRO-1 moments
    ``init_opt_state(blocks, zero_dims)`` makes have the reference's
    ``opt_state_axes`` blocks; the decode state ``init_decode_state``
    makes, the reference's ``state_shardings`` blocks."""
    import dataclasses
    from repro_torch.train import build_train_step, init_opt_state
    from repro_torch.train.optimizer import AdamWConfig
    rcfg, cfg = ref_reduced(arch), reduced_config(arch)
    v = -(-cfg.vocab_size // 4) * 4
    rcfg = dataclasses.replace(rcfg, vocab_size=v)
    cfg = dataclasses.replace(cfg, vocab_size=v)
    ref, _ = _ctxs()
    want = dict(_paths(_unstack_params(rcfg, _shard_shapes(
        ref_model.abstract_params(rcfg), ref_specs.param_shardings(rcfg,
                                                                   ref)))))
    moments = dict(_paths(_ref_moment_shapes(rcfg, ref)))
    params = port_model.abstract_params(cfg)
    whole = dict(tree_paths(params))
    flags = RunFlags(engram_strategy="pooled")
    state = specs.abstract_decode_state(cfg, flags, 4, 16, device="meta")
    for coords in ((0, 0), (1, 2)):
        mesh = rules.Mesh.of((2, 4), ("data", "model"), coords=dict(zip(
            ("data", "model"), coords)))
        with rules.sharding_ctx(mesh) as ctx:
            held = port_model.whole_leaves(cfg, ctx)
            assert set(held) == {p for p in whole if p.startswith("engram/")
                                 and p.endswith("/proj")}
            for axes in (port_model.mesh_logical_axes(cfg),
                         port_model.train_logical_axes(cfg, flags)):
                blocks = rules.local_params(params, axes, ctx)
                got = {p: tuple(t.shape) for p, t in tree_paths(blocks)}
                assert {p: s for p, s in got.items() if p not in held} == {
                    p: s for p, s in want.items() if p not in held}
                assert all(got[p] == tuple(whole[p].shape) for p in held)
            step = build_train_step(cfg, flags, AdamWConfig(), ctx=ctx)
            opt = init_opt_state(blocks, step.zero)
            assert {p: tuple(t.shape) for p, t in tree_paths(opt["m"])
                    if p not in held} == {p: s for p, s in moments.items()
                                          if p not in held}
            got = port_model.init_decode_state(cfg, flags, 2, 16, "meta")
        assert {p: tuple(t.shape) for p, t in tree_paths(got)} == dict(
            _paths(specs.state_shardings(state, ctx)))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("optimized", [False, True])
def test_cell_rules_match_reference_rule(shape, multi_pod, optimized):
    """The reference's ``cell_rules`` (repro/launch/dryrun.py:43, which
    cannot be imported beside the test process's JAX: it sets 512 host
    devices), restated for each arch against the port's."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = rules.Mesh.of((2, 16, 16) if multi_pod else (16, 16), axes)
    dp = 32 if multi_pod else 16
    sh = configs.SHAPES[shape]
    for arch in ref_base.list_archs():
        cfg = configs.get_config(arch)
        want = {}
        if sh.kind == "decode" and sh.global_batch < dp:
            want["kv_seq"] = ("data",)
        if optimized and sh.kind == "decode" and "kv_seq" not in want and (
                cfg.attn_impl == "mla" or cfg.n_kv_heads % 16):
            want["kv_seq"] = ("model",)
        assert dryrun.cell_rules(cfg, sh, mesh, optimized) == want, arch


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cells.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "torch_dryrun_cells.py"),
                          str(out)], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


def _keys(rec) -> set:
    keys = set(rec)
    for outer in ("memory", "cost"):
        keys |= {f"{outer}.{k}" for k in rec.get(outer, {})}
    return keys


def test_records_are_ok_with_the_reference_keys(cells):
    want = REF_KEYS - set(dryrun.NO_COUNTERPART)
    for name, rec in cells["records"].items():
        assert rec["ok"], (name, rec.get("traceback"))
        assert want <= _keys(rec), (name, want - _keys(rec))
        assert not _keys(rec) & set(dryrun.NO_COUNTERPART), name
        assert rec["unmirrored"] == [], name
        assert rec["scaled"]["flops_dot"] > 0
        mem = rec["memory"]
        assert mem["peak_bytes_est"] >= mem["argument_bytes"] > 0


def test_the_meshes_and_the_ranks(cells):
    recs = cells["records"]
    assert (recs["meta"]["mesh"], recs["meta"]["n_devices"]) == ("16x16", 256)
    assert (recs["pod2"]["mesh"], recs["pod2"]["n_devices"]) == (
        "2x16x16", 512)
    # a rank of the multi-pod mesh holds half the batch of the single pod's
    assert recs["pod2"]["scaled"]["flops_dot"] == pytest.approx(
        recs["meta"]["scaled"]["flops_dot"] / 2, rel=1e-12)
    assert recs["meta"]["model_flops"] == ref_analysis.model_flops(
        ref_base.get_config("gemma3-1b"), ref_base.SHAPES["decode_32k"])


def test_unroll_changes_no_count(cells):
    a, b = cells["records"]["meta"], cells["records"]["unroll"]
    assert (a["unroll"], b["unroll"]) == (False, True)
    for k in ("scaled", "kernel_calls", "memory"):
        assert a[k] == b[k], k


def test_kernels_on_the_cards_path_only(cells):
    """gemma3-1b's config pools its tables (``pooled``): on the card's
    path K1 is the owners' read and K2 the fusion, one call each per
    Engram layer, and K3 the decode attention, one call a layer; the CPU
    path runs their plain versions. The FLOPs differ by the local layers'
    keys past the window alone: the CPU's plain route multiplies every one
    of the 32,768 positions and masks them, K3 is charged the window's 512
    (a rank computes one query head: its 64 of wo's 1024 rows lie in one
    256-wide head; its batch is 128 over the 16 ranks of "data")."""
    meta, cpu = cells["records"]["meta"], cells["records"]["cpu"]
    cfg = configs.get_config("gemma3-1b")
    assert meta["kernel_calls"] == {"repro_torch::engram_gather": 2,
                                    "repro_torch::gated_fuse": 2,
                                    "repro_torch::decode_attention":
                                        cfg.n_layers}
    assert cpu["kernel_calls"] == {} and cpu["device"] == "cpu"
    shape = configs.SHAPES["decode_32k"]
    n_local = sum(k == "local" for k in cfg.attn_kinds)
    past = 4 * 1 * cfg.head_dim * (shape.global_batch // 16) * (
        shape.seq_len - cfg.window_size) * n_local
    assert cpu["scaled"]["flops_dot"] - meta["scaled"]["flops_dot"] == past
    # the pool's three all-to-alls a layer; the layout's all-reduces: a
    # layer's q, k and v gathered whole (1024 and 256 columns over 16
    # ranks do not fall on a 256-wide head's boundary), wo's and the MLP's
    # partial sums, then the embedding's and the logits' gather
    n = configs.get_config("gemma3-1b").n_layers
    assert meta["scaled"]["collectives"]["counts"] == {
        "all-to-all": 6, "all-reduce": 5 * n + 2}


def test_moe_cells_trace_expert_parallelism(cells):
    train, dec = (cells["records"][f"moe_{s}"]
                  for s in ("train_4k", "decode_32k"))
    assert train["kernel_calls"] == {}           # training runs no kernel
    assert dec["kernel_calls"] == {"repro_torch::gated_fuse": 2}
    assert train["scaled"]["collectives"]["counts"]["all-reduce"] > 0
    # moe_ep_gather: the partial outputs and the aux loss summed over the
    # model axis, two all-reduces a MoE layer (the ragged path has none);
    # the layout: the shared experts' and the dense layer's MLP partial
    # sums, and in each layer's MLA q and the absorbed W_uk and W_uv
    # gathered whole (blocks of a quarter of a head) and wo's partial sums
    # (503 words do not split over 16: no vocabulary collective)
    cfg = reduced_config("deepseek-v2-236b")
    n_moe = sum(t == "moe" for t in cfg.ffn_types)
    assert n_moe > 0 and dec["scaled"]["collectives"]["counts"] == {
        "all-reduce": 2 * n_moe + n_moe + (cfg.n_layers - n_moe)
        + 4 * cfg.n_layers}


def test_recorded_collectives_match_reference(cells):
    want = ref_analysis.collective_stats("""
ENTRY %main {
  %ar = f32[1024,256]{1,0} all-reduce(f32[1024,256]{1,0} %x), replica_groups=[16,16]<=[256]
  %ag = bf16[64,128]{1,0} all-gather(bf16[8,128]{1,0} %y), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %rs = f32[8,128]{1,0} reduce-scatter(f32[64,128]{1,0} %z), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %a2a = f32[16,32]{1,0} all-to-all(f32[16,32]{1,0} %w), replica_groups=[16,16]<=[256]
}
""", 256)
    got = cells["collectives"]
    assert got["counts"] == want["counts"]
    for key in ("wire_bytes_per_device", "payload_bytes_per_device"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)


def test_report_renders_and_zero1_raises(cells):
    """The report renders; ``zero1`` is accepted and recorded, and changes
    no count (the port's train step always lays its gradients and moments
    out as ZeRO-1)."""
    text = cells["report"]
    assert text.startswith("Cells: 6/6 ok (pod1 5, pod2 1, fail 0)")
    for head in ("## Dry-run", "## Roofline (single-pod, one H100 per rank)",
                 "### Levers", "| gemma3-1b | decode_32k |"):
        assert head in text
    rec, meta = cells["zero1"], cells["records"]["meta"]
    assert rec["ok"] and rec["zero1"] is True and meta["zero1"] is False
    for k in ("scaled", "kernel_calls", "memory"):
        assert rec[k] == meta[k], k


def test_long_500k_cell_splits_the_kv_sequence(cells):
    """Reduced jamba x long_500k through the hillclimb driver: with the
    cell's rules (``kv_seq`` over "data": batch 1 cannot fill 16 data
    ranks) rank 0's KV blocks hold 1/16 of the sequence, so its arguments
    fall by 15/16 of the KV bytes exactly (every other leaf unchanged),
    and decode combines the ranks' partial softmaxes: a ``pmax`` and two
    ``psum`` over "data" per attention layer; with ``rule:kv_seq=`` the
    sequence is whole. Both records written, ``unmirrored`` empty."""
    kv = cells["kv_seq"]
    split, whole = kv["kv_seq"], kv["whole"]
    assert kv["kv_seq_written"] and kv["whole_written"]
    assert split["ok"] and whole["ok"], (split.get("error"),
                                         whole.get("error"))
    assert split["rules"] == {"kv_seq": ["data"]}
    assert whole["rules"] == {"kv_seq": []}
    assert split["unmirrored"] == whole["unmirrored"] == []
    cfg = reduced_config("jamba-1.5-large-398b")
    n_attn = cfg.layer_types.count("attn")
    S = configs.SHAPES["long_500k"].seq_len
    kv_bytes = n_attn * 2 * S * cfg.n_kv_heads * cfg.head_dim * 2   # bf16
    assert whole["memory"]["argument_bytes"] - \
        split["memory"]["argument_bytes"] == kv_bytes * 15 // 16
    assert split["memory"]["peak_bytes_est"] < \
        whole["memory"]["peak_bytes_est"]
    assert split["scaled"]["bytes_accessed"] < \
        whole["scaled"]["bytes_accessed"]
    counts = (split["collectives"]["counts"], whole["collectives"]["counts"])
    assert counts[0]["all-reduce"] - counts[1]["all-reduce"] == 3 * n_attn


def test_hillclimb_parse_flags_is_the_reference(tmp_path):
    """The hillclimb twin's ``parse_flags`` against the reference's
    (experiments/hillclimb.py, imported in a subprocess: its import pins
    512 host devices) on the same argument lists."""
    from repro_torch.experiments.hillclimb import RESERVED, parse_flags
    cases = [[], ["attn_bf16_scores=true", "remat=False", "q_chunk=512"],
             ["moe=alltoall", "engram=pooled", "rule:kv_seq=model",
              "rule:heads=", "rule:batch=pod,data", "x=1.5"],
             ["device=meta", "zero1=true", "unroll=false"]]
    code = ("import json, sys; sys.path.insert(0, 'experiments'); "
            "from hillclimb import parse_flags; "
            f"print(json.dumps([parse_flags(a) for a in {cases!r}]))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu",
                                  PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-4000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = [parse_flags(a) for a in cases]
    assert [[f, {k: list(v) for k, v in r.items()}] for f, r in got] == want
    assert set(RESERVED) == {"moe", "engram", "remat", "unroll", "zero1",
                             "device"}
