"""PyTorch port vs the JAX reference: the sharding rules, without ranks.

``DEFAULT_RULES`` and ``ShardCtx.spec_for`` against the reference's on a
grid of shapes (B = 1, dims that do not divide, multi-axis rules, the
multi-pod mesh), with a stand-in mesh (the reference's ``ShardCtx`` reads
only ``mesh.shape`` and ``mesh.axis_names``), so this runs in the
1-device pytest process; ``params_logical_axes`` against the reference's
for every registered config, full and reduced (the reference's stacked
leaves unstacked to the port's per-layer blocks, their ``layers`` axis
dropped); ``local_params`` blocks, one set per rank of a (2, 4) mesh,
reassembled into the whole tree; ``make_mesh`` refusing to run without a
process group."""
import itertools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.launch.train import reduced_config as ref_reduced  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.transformer import segment_plan as ref_plan  # noqa: E402
from repro.sharding import rules as ref_rules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import deepseek_v3_671b  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch.train import reduced_config  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

MESHES = [((2, 4), ("data", "model")), ((1, 1), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((8,), ("data",))]
LOGICAL = [None, "batch", "seq", "vocab", "heads", "kv_heads", "ffn",
           "experts", "eng_vocab", "eng_emb", "layers", "opt"]
SHAPES = [(1,), (2,), (3,), (4,), (8,), (12,), (16,), (509,), (4096,),
          (32, 4096), (1, 8, 16), (4, 8, 16), (6, 4, 256), (2, 512, 32)]


def _ref_ctx(shape, axes, extra=None):
    mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)
    return ref_rules.ShardCtx(mesh, {**ref_rules.DEFAULT_RULES,
                                     **(extra or {})})


def _port_ctx(shape, axes, extra=None, coords=None):
    return rules.ShardCtx(rules.Mesh.of(shape, axes, coords=coords),
                          {**rules.DEFAULT_RULES, **(extra or {})})


def test_default_rules_equal_reference():
    assert rules.DEFAULT_RULES == ref_rules.DEFAULT_RULES


@pytest.mark.parametrize("extra", [None, {"batch": ("data", "model")},
                                   {"eng_vocab": ("model",)}])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    f"{a}{n}" for n, a in zip(*m)))
def test_spec_for_matches_reference(mesh, extra):
    """Every shape of the grid under every pair (or triple) of logical axes:
    the same spec, the divisibility fallback included."""
    ref, port = _ref_ctx(*mesh, extra), _port_ctx(*mesh, extra)
    n = 0
    for shape in SHAPES:
        for names in itertools.product(LOGICAL, repeat=len(shape)):
            want = ref.spec_for(shape, names)
            assert port.spec_for(shape, names) == tuple(want), (shape, names)
            n += 1
    for name in LOGICAL:
        assert port.resolve(name) == ref.resolve(name)
    assert n > 1000


def test_axis_size_and_mesh_axes_match_reference():
    shape, axes = (2, 16, 16), ("pod", "data", "model")
    ref_mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                     axis_names=axes)
    for name in LOGICAL[1:]:
        with ref_rules.sharding_ctx(ref_mesh):
            want = (ref_rules.axis_size(name), ref_rules.mesh_axes(name))
        with rules.sharding_ctx(rules.Mesh.of(shape, axes)):
            got = (rules.axis_size(name), rules.mesh_axes(name))
        assert got == want, name
    assert rules.current_ctx() is None
    assert (rules.axis_size("batch"), rules.mesh_axes("batch")) == (1, ())


def _unstack(cfg, rax):
    """The reference's axes tree in the port's layout: each stacked leaf
    once per layer, its leading ``layers`` axis dropped."""
    is_axes = lambda x: isinstance(x, tuple)                 # noqa: E731
    segs = []
    for seg, sp in zip(ref_plan(cfg), rax["segments"]):
        blocks = list(sp["prefix"])
        for _ in range(seg.n_periods):
            blocks += [jax.tree.map(lambda a: tuple(a[1:]), b, is_leaf=is_axes)
                       for b in sp["stack"]]
        segs.append(blocks)
    out = jax.tree.map(tuple, {k: v for k, v in rax.items()
                               if k != "segments"}, is_leaf=is_axes)
    return {**out, "segments": segs}


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ref_base.list_archs())
def test_params_logical_axes_match_reference(arch, size):
    rcfg = ref_base.get_config(arch) if size == "full" else ref_reduced(arch)
    cfg = configs.get_config(arch) if size == "full" else reduced_config(arch)
    assert port_model.params_logical_axes(cfg) == _unstack(
        rcfg, ref_model.params_logical_axes(rcfg))


def test_mesh_logical_axes_keep_only_blockwise_leaves():
    """The port's mesh layout is the reference's ``params_logical_axes``
    but for the leaves of ``WHOLE_LEAVES`` (each Engram layer's ``proj``,
    which K2 reads whole): the dense weights, the head, the embedding, the
    tables and the routed experts keep their axes."""
    cfg = deepseek_v3_671b.reduced()
    full = port_model.params_logical_axes(cfg)
    kept = port_model.mesh_logical_axes(cfg)
    assert kept["embed"] == full["embed"]
    assert kept["head"] == full["head"] == {"w": (None, "vocab")}
    for got, want in zip(kept["engram"]["layers"], full["engram"]["layers"]):
        assert got["tables"] == want["tables"] == (None, "eng_vocab", None)
        assert got["proj"] == (None, None) and want["proj"] == (
            "eng_emb", None)
        got["proj"] = want["proj"]
    assert kept == full
    ffn = kept["segments"][1][0]["ffn"]
    assert ffn["w_gu"] == ffn["w_down"] == ("experts", None, None)
    assert ffn["shared"]["gate"] == (None, "ffn")
    assert kept["segments"][0][0]["mixer"]["wuq"] == (None, "heads")


@pytest.mark.parametrize("mesh", [((2, 4), ("data", "model")),
                                  ((2, 2, 2), ("pod", "data", "model"))],
                         ids=["2x4", "2x2x2"])
def test_local_params_blocks_reassemble_the_tree(mesh):
    """One set of blocks per rank (every coordinate of the mesh): each block
    is a view of the whole leaf at the offset its spec gives, and the
    blocks of the ranks tile the leaf."""
    shape, axes = mesh
    cfg = deepseek_v3_671b.reduced()
    params = port_model.init_params(cfg, 0, "cpu")
    ax_tree = port_model.params_logical_axes(cfg)
    whole = list(tree_leaves(params))
    rebuilt = [torch.full_like(t, float("nan")) for t in whole]
    sharded = 0
    for coords in itertools.product(*(range(n) for n in shape)):
        ctx = _port_ctx(shape, axes, coords=dict(zip(axes, coords)))
        blocks = list(tree_leaves(rules.local_params(params, ax_tree, ctx)))
        for i, (b, t, ax) in enumerate(zip(blocks, whole,
                                           tree_leaves_axes(ax_tree))):
            assert b.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr()
            spec = ctx.spec_for(tuple(t.shape), ax)
            sl = []
            for d, entry in enumerate(spec):
                n = t.shape[d] // (ctx.axis_prod((entry,) if isinstance(
                    entry, str) else entry) if entry else 1)
                k = ctx.mesh.index(entry) if entry else 0
                sl.append(slice(k * n, (k + 1) * n))
            assert b.shape == t[tuple(sl)].shape
            rebuilt[i][tuple(sl)] = b
            sharded += b.numel() < t.numel()
    for got, want in zip(rebuilt, whole):
        assert torch.equal(got, want)
    assert sharded > 0


def tree_leaves_axes(ax_tree):
    """The axes tuples of an axes tree, in leaf order."""
    if isinstance(ax_tree, dict):
        ax_tree = list(ax_tree.values())
    if isinstance(ax_tree, list):
        for v in ax_tree:
            yield from tree_leaves_axes(v)
    else:
        yield ax_tree


def test_rank_block_takes_whole_or_block_and_refuses_others():
    ctx = _port_ctx((2, 4), ("data", "model"), coords={"data": 1,
                                                       "model": 2})
    t = torch.arange(8 * 3).view(8, 3)
    assert torch.equal(rules.rank_block(t, 0, 8, ("model",), ctx), t[4:6])
    assert torch.equal(rules.rank_block(t, 0, 8, ("data", "model"), ctx),
                       t[6:7])
    assert rules.rank_block(t[4:6], 0, 8, ("model",), ctx).shape == (2, 3)
    with pytest.raises(ValueError):
        rules.rank_block(t[:3], 0, 8, ("model",), ctx)
    with pytest.raises(ValueError):
        ctx.mesh.index(("model", "data"))        # not in layout order


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_fused_leaves_take_each_parts_block(arch, tmp_path):
    """A fused leaf (Mamba's ``in_proj`` [x | z], mLSTM's ``up``, sLSTM's
    ``ff_up``) is split part by part: on each rank of a (2, 4) mesh its
    block is the rank's block of each part side by side, of the
    reference's block shape; ``from_jax(block=)``, ``init_params(block=)``
    and ``Checkpointer.restore(block=)`` give the rank the same blocks as
    ``local_params`` of the whole tree."""
    import numpy as np
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.params import from_jax, tree_paths
    cfg = reduced_config(arch)
    rcfg = ref_reduced(arch)
    np_tree = jax.tree.map(np.asarray, ref_model.init_params(rcfg, 0))
    whole = from_jax(np_tree, cfg, "cpu")
    drawn = port_model.init_params(cfg, 0, "cpu")
    axes = port_model.mesh_logical_axes(cfg)
    flat_axes = dict(tree_paths(axes, is_leaf=lambda x: isinstance(
        x, tuple)))
    fused = {p: a for p, a in flat_axes.items()
             if isinstance(a, rules.Fused)}
    assert fused and all(a.parts == 2 for a in fused.values())
    ckpt = Checkpointer(tmp_path, async_write=False)
    ckpt.save(1, whole)
    for coords in itertools.product(range(2), range(4)):
        mesh = rules.Mesh.of((2, 4), ("data", "model"),
                             coords=dict(zip(("data", "model"), coords)))
        with rules.sharding_ctx(mesh) as ctx:
            mine = dict(tree_paths(rules.local_params(whole, axes, ctx)))
            bridged = dict(tree_paths(from_jax(np_tree, cfg, "cpu",
                                               block=axes)))
            blocks = dict(tree_paths(port_model.init_params(
                cfg, 0, "cpu", block=axes)))
            ref_drawn = dict(tree_paths(rules.local_params(drawn, axes,
                                                           ctx)))
            restored = dict(tree_paths(ckpt.restore(1, whole, "cpu",
                                                    block=axes)))
        full = dict(tree_paths(whole))
        split = 0
        for p, a in fused.items():
            t, n = full[p], 4
            if not ctx.spec_for(tuple(t.shape), a):   # 2f = 170 over 4
                assert torch.equal(mine[p], t), p
                continue
            split += 1
            parts = [q.chunk(n, a.dim)[coords[1]]
                     for q in t.chunk(a.parts, a.dim)]
            assert torch.equal(mine[p], torch.cat(parts, a.dim)), p
            assert tuple(mine[p].shape) == ctx.block_shape(tuple(t.shape),
                                                           a)
        assert split > 0
        for p in mine:
            assert torch.equal(bridged[p], mine[p]), p
            assert torch.equal(restored[p], mine[p]), p
            assert torch.equal(blocks[p], ref_drawn[p]), p
