"""PyTorch port's checkpointer (``repro_torch.checkpoint``) on the CPU:
twins of tests/test_checkpoint.py (roundtrip, async write, an incomplete
``.tmp`` ignored, garbage collection, a structure mismatch, the elastic
restore), bf16 leaves bit for bit through their uint16 bits, the
reference's layout read by the port and the port's read by the reference,
and a trainer's state restored into ``abstract_params`` on the ``meta``
device."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import Checkpointer as RefCheckpointer  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import deepseek_7b  # noqa: E402
from repro_torch.models.model import abstract_params  # noqa: E402
from repro_torch.models.params import init_params, tree_leaves  # noqa: E402
from repro_torch.sharding.rules import Mesh, sharding_ctx  # noqa: E402
from repro_torch.train import abstract_opt_state, init_opt_state  # noqa: E402

torch.set_num_threads(2)


def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "layers": [{"a": torch.ones(2)},
                                  {"a": torch.zeros(2)}]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, async_write=False)
    t = tree()
    ck.save(3, t, meta={"loss": 1.5})
    assert ck.latest_step() == 3
    _equal(ck.restore(3, t, "cpu"), t)
    assert ck.restore_meta(3)["loss"] == 1.5


def test_async_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, async_write=True)
    t = tree()
    ck.save(5, t)
    ck.wait()
    assert ck.latest_step() == 5
    _equal(ck.restore(5, t, "cpu"), t)


def test_incomplete_tmp_ignored(tmp_path):
    ck = Checkpointer(tmp_path, async_write=False)
    ck.save(1, tree())
    # a crash mid-write: a .tmp dir that was never renamed
    broken = tmp_path / "step_000002.tmp"
    broken.mkdir()
    (broken / "0000_x.npy").write_bytes(b"junk")
    assert ck.latest_step() == 1


def test_gc_keeps_last(tmp_path):
    ck = Checkpointer(tmp_path, keep_last=2, async_write=False)
    for s in (1, 2, 3, 4):
        ck.save(s, tree())
    assert ck.list_steps() == [3, 4]


def test_structure_mismatch_raises(tmp_path):
    ck = Checkpointer(tmp_path, async_write=False)
    ck.save(1, tree())
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(1, {"other": torch.zeros(())}, "cpu")
    bad = tree()
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(1, bad, "cpu")


@pytest.mark.parametrize("coords", [(0, 0), (1, 2), (1, 3)])
def test_restore_is_elastic_relayout(tmp_path, coords):
    """Whole leaves on disk; ``block`` narrows each to a rank's block on
    another mesh: (2, 4) ("x", "y"), ``w`` rows over y and columns over x,
    ``b`` over both (the reference's check_elastic_checkpoint layout)."""
    ck = Checkpointer(tmp_path, async_write=False)
    t = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.arange(16.0)}
    ck.save(2, t)
    x, y = coords
    mesh = Mesh.of((2, 4), ("x", "y"), coords={"x": x, "y": y})
    with sharding_ctx(mesh, rules={"r": ("y",), "c": ("x",),
                                   "rc": ("x", "y")}):
        out = ck.restore(2, t, "cpu", block={"w": ("r", "c"), "b": ("rc",)})
    assert torch.equal(out["w"], t["w"][y * 2:(y + 1) * 2, x * 4:(x + 1) * 4])
    assert torch.equal(out["b"], t["b"][(x * 4 + y) * 2:(x * 4 + y + 1) * 2])


def test_block_needs_a_sharding_context(tmp_path):
    ck = Checkpointer(tmp_path, async_write=False)
    ck.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="sharding context"):
        ck.restore(1, {"w": torch.ones(4)}, "cpu", block={"w": ("r",)})


def test_bf16_leaves_bit_for_bit(tmp_path):
    """A bf16 leaf goes to disk as its uint16 bits, the manifest says
    bfloat16, and it comes back bit-equal (NaN and -0.0 included)."""
    ck = Checkpointer(tmp_path, async_write=False)
    w = torch.randn(5, 7).to(torch.bfloat16)
    w[0, 0], w[0, 1] = float("nan"), -0.0
    ck.save(1, {"w": w})
    man = json.loads((tmp_path / "step_000001" / "manifest.json").read_text())
    assert man["leaves"]["w"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_000001" / man["leaves"]["w"]["file"]
                   ).dtype == np.uint16
    out = ck.restore(1, {"w": torch.empty(5, 7, device="meta")}, "cpu")["w"]
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), w.view(torch.int16))


def test_layout_is_the_references(tmp_path):
    """The reference's checkpoint (f32, int32, nested lists) restores in
    the port, and the port's in the reference: same names, files,
    manifest."""
    ref = {"params": {"w": jnp.arange(12.0).reshape(3, 4),
                      "layers": [{"a": jnp.ones((2,))},
                                 {"a": jnp.zeros((2,))}]},
           "step": jnp.asarray(7, jnp.int32)}
    RefCheckpointer(tmp_path / "ref", async_write=False).save(4, ref)
    got = Checkpointer(tmp_path / "ref").restore(4, tree(), "cpu")
    _equal(got, tree())
    Checkpointer(tmp_path / "port", async_write=False).save(4, tree())
    back = RefCheckpointer(tmp_path / "port").restore(4, ref)
    for a, b in zip(tree_leaves(tree()), [back["params"]["w"],
                                          back["params"]["layers"][0]["a"],
                                          back["params"]["layers"][1]["a"],
                                          back["step"]]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert sorted(p.name for p in (tmp_path / "ref" / "step_000004").iterdir()
                  ) == sorted(p.name for p in (tmp_path / "port" /
                                               "step_000004").iterdir())


def test_trainer_state_restores_into_abstract_params(tmp_path):
    """A model's parameters and AdamW state, saved and restored into
    ``abstract_params`` / ``abstract_opt_state`` (meta tensors)."""
    cfg = deepseek_7b.reduced()
    params = init_params(cfg, 0, "cpu", dtype="bfloat16")
    state = init_opt_state(params)
    ck = Checkpointer(tmp_path, async_write=True)
    ck.save(9, {"params": params, "opt": state})
    ck.wait()
    ab = abstract_params(cfg, "bfloat16")
    assert all(t.device.type == "meta" for t in tree_leaves(ab))
    out = ck.restore(9, {"params": ab, "opt": abstract_opt_state(ab)}, "cpu")
    _equal(out["params"], params)
    _equal(out["opt"], state)
