"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips on a machine without a CUDA device (the
kernels have no CPU mode). This file imports nothing of JAX, so it runs on
the GPU machine: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.engram_gather import (engram_gather,  # noqa: E402
                                               engram_gather_ref,
                                               gather_rows, gather_rows_ref)
from repro_torch.kernels.gated_fuse import (engram_gated_fuse,  # noqa: E402
                                            gated_fuse_ref)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: both sides accumulate in f32, in another order
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 out: one bf16 ulp (8-bit significand) of rounding difference
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [160, 7])
def test_gather_rows_kernel_bit_equal(dtype, hd):
    dev = _card()
    table = torch.randn(4096, hd, device=dev).to(TORCH_DTYPES[dtype])
    gid = torch.randint(0, 4096, (333,), device=dev)
    before = gather_rows.launches
    got = gather_rows(table, gid)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_ref(table, gid))


@pytest.mark.cuda
def test_engram_gather_kernel_bit_equal():
    dev = _card()
    tables = torch.randn(16, 512, 160, device=dev).to(torch.bfloat16)
    idx = torch.randint(0, 512, (8, 1, 16), device=dev)
    assert torch.equal(engram_gather(tables, idx),
                       engram_gather_ref(tables, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d,F", [(8, 512, 256), (37, 100, 36)])
def test_gated_fuse_kernel_close(dtype, T, d, F):
    dev = _card()
    rng = np.random.RandomState(0)
    ops = [torch.from_numpy(a).to(dev, TORCH_DTYPES[dtype]) for a in (
        rng.randn(T, d), rng.randn(T, F), rng.randn(d, d) / np.sqrt(d),
        rng.randn(F, d) / np.sqrt(F))]
    before = engram_gated_fuse.launches
    got = engram_gated_fuse(*ops)
    torch.cuda.synchronize()
    assert engram_gated_fuse.launches == before + 1
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), gated_fuse_ref(*ops).float(),
                               **tol)


@pytest.mark.cuda
def test_empty_inputs_launch_nothing():
    """Counters grow only where a kernel launches: an empty input returns
    an empty output without a launch."""
    dev = _card()
    g0, f0 = gather_rows.launches, engram_gated_fuse.launches
    table = torch.randn(64, 160, device=dev).to(torch.bfloat16)
    assert gather_rows(table, torch.zeros(0, dtype=torch.int64,
                                          device=dev)).shape == (0, 160)
    h = torch.zeros(0, 128, device=dev)
    out = engram_gated_fuse(h, torch.zeros(0, 64, device=dev),
                            torch.zeros(128, 128, device=dev),
                            torch.zeros(64, 128, device=dev))
    assert out.shape == (0, 128)
    assert (gather_rows.launches, engram_gated_fuse.launches) == (g0, f0)
