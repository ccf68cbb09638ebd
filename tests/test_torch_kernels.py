"""PyTorch port vs the JAX reference: the two kernels' plain versions (what
a CPU tensor runs) against the reference's Pallas kernels in interpret mode
and its plain oracles, and the wrappers' CPU dispatch.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
Inputs are drawn with numpy and fed to both packages."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import engram_27b as ref_engram_27b  # noqa: E402
from repro.core.engram import engram_fuse as ref_engram_fuse  # noqa: E402
from repro.core.engram import padded_vocab as ref_padded_vocab  # noqa: E402
from repro.core.engram import \
    retrieve_local as ref_retrieve_local  # noqa: E402
from repro.kernels.engram_gather.ops import \
    engram_gather as ref_engram_gather  # noqa: E402
from repro.kernels.engram_gather.ref import \
    gather_rows_ref as ref_gather_rows  # noqa: E402
from repro.kernels.gated_fuse.ops import \
    engram_gated_fuse as ref_gated_fuse  # noqa: E402
from repro_torch.configs import engram_27b  # noqa: E402
from repro_torch.core.engram import engram_fuse, retrieve_local  # noqa
from repro_torch.kernels.engram_gather import (engram_gather,  # noqa: E402
                                               engram_gather_ref,
                                               gather_rows, gather_rows_multi,
                                               gather_rows_ref)
from repro_torch.kernels.gated_fuse import (engram_gated_fuse,  # noqa: E402
                                            gated_fuse_ref)
from repro_torch.kernels.gated_fuse.ops import BK, plan_split  # noqa: E402
from repro_torch.models.params import to_torch  # noqa: E402

torch.set_num_threads(2)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: both sides accumulate in f32, in another order
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 out: one bf16 ulp (8-bit significand) of rounding difference
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw bits, so equality is bit-equality in any dtype."""
    t = t.contiguous()
    view = torch.int16 if t.element_size() == 2 else torch.int32
    return t.view(view).numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


# ------------------------------------------------------------------- K1

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,V,hd,B,S", [
    (2, 64, 16, 2, 4),        # tiny, unaligned hd
    (4, 128, 128, 1, 8),      # lane-aligned hd
    (16, 512, 160, 2, 3),     # Engram-27B head shape (160 dims)
    (1, 32, 8, 1, 1),         # single row
])
def test_engram_gather_bit_equal_to_reference(T, V, hd, B, S, dtype):
    """The sweep of tests/test_kernels.py: the port's K1 on a CPU tensor
    (its plain version) == the Pallas kernel in interpret mode == the
    reference's oracle, bit for bit."""
    rng = np.random.RandomState(T * 1000 + hd)
    tables_j = jnp.asarray(rng.randn(T, V, hd), jnp.dtype(dtype))
    idx = rng.randint(0, V, (B, S, T))
    want = ref_engram_gather(tables_j, jnp.asarray(idx, jnp.int32),
                             interpret=True)
    tables = to_torch(np.asarray(tables_j), torch.device("cpu"))
    got = engram_gather(tables, torch.from_numpy(idx))
    assert tuple(got.shape) == (B, S, T, hd)
    np.testing.assert_array_equal(_bits(got), _jax_bits(want))
    np.testing.assert_array_equal(
        _bits(engram_gather_ref(tables, torch.from_numpy(idx))),
        _jax_bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_bit_equal_to_reference(dtype):
    rng = np.random.RandomState(0)
    table_j = jnp.asarray(rng.randn(256, 160), jnp.dtype(dtype))
    gid = rng.randint(0, 256, (37,))
    want = ref_gather_rows(table_j, jnp.asarray(gid))
    table = to_torch(np.asarray(table_j), torch.device("cpu"))
    got = gather_rows(table, torch.from_numpy(gid))
    np.testing.assert_array_equal(_bits(got), _jax_bits(want))
    # first/last rows, repeats, and a non-contiguous row view
    edge = torch.tensor([0, 255, 0, 255])
    np.testing.assert_array_equal(_bits(gather_rows(table, edge)),
                                  _bits(table[edge]))
    sub = table[:, 3:100]
    np.testing.assert_array_equal(_bits(gather_rows(sub, edge)),
                                  _bits(sub[edge]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_multi_bit_equal_to_reference(dtype):
    """K1's multi-table entry on CPU tensors: each table's rows equal the
    reference's gather of that table, bit for bit, whatever the tables'
    row counts and row strides."""
    rng = np.random.RandomState(1)
    tabs_j = [jnp.asarray(rng.randn(r, 24), jnp.dtype(dtype))
              for r in (300, 41)]
    gid = np.stack([rng.randint(0, 300, 19), rng.randint(0, 41, 19)])
    cpu = torch.device("cpu")
    tabs = [to_torch(np.asarray(t), cpu) for t in tabs_j]
    tabs[1] = torch.cat([tabs[1], tabs[1][:, :5]], dim=1)[:, :24]  # strided
    got = gather_rows_multi(tabs, torch.from_numpy(gid))
    assert tuple(got.shape) == (2, 19, 24)
    for j in range(2):
        np.testing.assert_array_equal(
            _bits(got[j]),
            _jax_bits(ref_gather_rows(tabs_j[j], jnp.asarray(gid[j]))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retrieve_local_bit_equal_to_reference(dtype):
    """Prefill retrieval (strategy local, and pooled/tp without a mesh) is
    the port's own one-gather counterpart of the reference's ``_take_rows``
    and equals the reference's ``retrieve_local`` bit for bit, on the
    reduced engram-27b table shape."""
    cfg, rcfg = engram_27b.reduced(), ref_engram_27b.reduced()
    e = cfg.engram
    rng = np.random.RandomState(4)
    tables_j = jnp.asarray(
        rng.randn(e.n_tables, ref_padded_vocab(rcfg.engram), e.head_dim),
        jnp.dtype(dtype))
    idx = rng.randint(0, e.table_vocab, (3, 5, e.n_tables))
    want = ref_retrieve_local(rcfg.engram, tables_j, jnp.asarray(idx))
    tables = to_torch(np.asarray(tables_j), torch.device("cpu"))
    got = retrieve_local(e, tables, torch.from_numpy(idx))
    assert tuple(got.shape) == (3, 5, e.n_tables * e.head_dim)
    np.testing.assert_array_equal(_bits(got), _jax_bits(want))


def test_gather_rows_rejects_out_of_range_on_cpu():
    with pytest.raises(IndexError):
        gather_rows(torch.zeros(4, 8), torch.tensor([4]))


# ------------------------------------------------------------------- K2

def _fuse_inputs(T, d, F, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(T, d), rng.randn(T, F),
            rng.randn(d, d) / np.sqrt(d), rng.randn(F, d) / np.sqrt(F))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [16, 13])
def test_gated_fuse_matches_interpret_kernel(dtype, T):
    """K2's plain version == the Pallas kernel run in interpret mode at
    d = 128, F = 256 (lane-aligned, so the reference really takes its
    kernel; T = 13 exercises its row padding)."""
    arrs = _fuse_inputs(T, 128, 256)
    js = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrs]
    want = np.asarray(ref_gated_fuse(*js, interpret=True), np.float32)
    ts = [to_torch(np.asarray(j), torch.device("cpu")) for j in js]
    got = engram_gated_fuse(*ts)
    assert got.dtype == TORCH_DTYPES[dtype]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_fusion_vs_reference_model_fusion(dtype):
    """F1: the port fuses through K2 (f32 epilogue); the reference model
    fuses with ``engram_fuse(use_kernel=False)``, which casts the gate to
    h's dtype first. At f32 the two differ only in summation order. In bf16
    the reference form rounds the update, the gate and their product to
    bf16 before the add: up to about four bf16 ulps (2**-6 relative) of
    difference."""
    cfg = engram_27b.reduced()
    rcfg = ref_engram_27b.reduced()
    d, F = cfg.d_model, len(cfg.engram.orders) * cfg.engram.emb_dim
    rng = np.random.RandomState(3)
    h, rows = rng.randn(2, 5, d), rng.randn(2, 5, F)
    fuse_np = {"gate": rng.randn(d, d) / np.sqrt(d),
               "proj": rng.randn(F, d) / np.sqrt(F),
               "norm": {"scale": 1.0 + 0.1 * rng.randn(F)}}
    jd = jnp.dtype(dtype)
    jfuse = {"gate": jnp.asarray(fuse_np["gate"], jd),
             "proj": jnp.asarray(fuse_np["proj"], jd),
             "norm": {"scale": jnp.asarray(fuse_np["norm"]["scale"],
                                           jnp.float32)}}
    want = np.asarray(ref_engram_fuse(rcfg, jfuse, jnp.asarray(h, jd),
                                      jnp.asarray(rows, jd)), np.float32)
    cpu = torch.device("cpu")
    tfuse = {"gate": to_torch(np.asarray(jfuse["gate"]), cpu),
             "proj": to_torch(np.asarray(jfuse["proj"]), cpu),
             "norm": {"scale": to_torch(np.asarray(jfuse["norm"]["scale"]),
                                        cpu)}}
    th = to_torch(np.asarray(jnp.asarray(h, jd)), cpu)
    trows = to_torch(np.asarray(jnp.asarray(rows, jd)), cpu)
    got = engram_fuse(cfg, tfuse, th, trows, use_kernel=True)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2.0 ** -6, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # and the port's own non-kernel form is the reference's, closely
    plain = engram_fuse(cfg, tfuse, th, trows, use_kernel=False)
    np.testing.assert_allclose(plain.float().numpy(), want,
                               **(F32_TOL if dtype == "float32"
                                  else BF16_TOL))


@pytest.mark.parametrize("d,F", [(5120, 2560), (100, 36), (64, 64),
                                 (130, 200), (512, 264), (4096, 0)])
@pytest.mark.parametrize("T", [1, 8, 13, 64, 65, 256])
def test_gated_fuse_split_plan_covers_every_slab_once(T, d, F):
    """K2's split planner: the token tile holds T (or tiles it at 128),
    the parts cover each contraction's slabs exactly once with none empty,
    and the grid is column tiles x token tiles x parts."""
    plan = plan_split(T, d, F)
    assert plan.bn in (8, 16, 32, 64, 128)
    assert plan.bn >= min(T, 128) and plan.bn * plan.tok_tiles >= T
    assert plan.bn * (plan.tok_tiles - 1) < T
    assert plan.col_tiles * 64 >= d > (plan.col_tiles - 1) * 64
    # part z < s_g covers g's slabs [z*q_g, (z+1)*q_g), then p's likewise
    # (blockIdx.z in csrc/gated_fuse.cu), the last part of each clipped
    ranges = []
    for kind, K, q, parts in (("g", d, plan.q_g, plan.s_g),
                              ("p", F, plan.q_p, plan.s_p)):
        slabs = -(-K // BK)
        ranges += [(kind, z * q, min((z + 1) * q, slabs))
                   for z in range(parts)]
    assert len(ranges) == plan.parts
    for kind, K in (("g", d), ("p", F)):
        covered = [s for k, a, b in ranges if k == kind for s in range(a, b)]
        assert all(b > a for k, a, b in ranges if k == kind)
        assert covered == list(range(-(-K // BK)))
    assert plan.grid == (plan.col_tiles, plan.tok_tiles, plan.parts)
    assert plan.blocks == plan.col_tiles * plan.tok_tiles * plan.parts


def test_gated_fuse_split_fills_the_card_at_decode():
    """At the decode shape (T = 8, d = 5120, F = 2560) the 80 column tiles
    alone would leave SMs idle: the split gives at least 132 blocks."""
    plan = plan_split(8, 5120, 2560)
    assert plan.col_tiles * plan.tok_tiles == 80
    assert plan.blocks >= 132 and plan.parts >= 2


# ----------------------------------------------------- wrappers on the CPU

def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor runs the plain version and launches nothing."""
    gather_rows.launches = 0
    engram_gated_fuse.launches = 0
    table = torch.randn(50, 8)
    gid = torch.tensor([3, 1, 49])
    assert torch.equal(gather_rows(table, gid), gather_rows_ref(table, gid))
    tabs = torch.randn(2, 10, 4)
    idx = torch.tensor([[[1, 9]]])
    assert torch.equal(engram_gather(tabs, idx), engram_gather_ref(tabs, idx))
    two = torch.tensor([[3, 1], [0, 49]])
    assert torch.equal(gather_rows_multi([table, table], two),
                       torch.stack([table[two[0]], table[two[1]]]))
    ops = [torch.from_numpy(a).float() for a in _fuse_inputs(3, 16, 8)]
    assert torch.equal(engram_gated_fuse(*ops), gated_fuse_ref(*ops))
    assert gather_rows.launches == 0
    assert engram_gated_fuse.launches == 0


def test_fuse_configs_match():
    """The port's engram-27b reduced config is the reference's, field by
    field (the K2 parity above relies on it)."""
    assert dataclasses.asdict(engram_27b.reduced()) == \
        dataclasses.asdict(ref_engram_27b.reduced())
