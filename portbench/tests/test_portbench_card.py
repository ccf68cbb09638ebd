"""On the card: the trace finds its marker, the device's busy time and the
device time of the kernels launched under the port's K1 and K2
operators. Skips without a CUDA device."""
import pytest
import torch

from portbench.harness.trace import STEP, Trace, analyse


@pytest.mark.cuda
def test_trace_reads_the_kernels_under_k1_and_k2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.engram_gather import gather_rows_multi
    from repro_torch.kernels.gated_fuse import engram_gated_fuse
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    d, F = 512, 256
    h = torch.randn(8, 1, d, device=dev, generator=g).bfloat16()
    e = torch.randn(8, 1, F, device=dev, generator=g).bfloat16()
    wg = torch.randn(d, d, device=dev, generator=g).bfloat16()
    wp = torch.randn(F, d, device=dev, generator=g).bfloat16()
    table = torch.randn(4096, 160, device=dev, generator=g).bfloat16()
    gid = torch.randint(0, 4096, (1, 128), device=dev, generator=g)
    engram_gated_fuse(h, e, wg, wp)
    gather_rows_multi([table], gid)
    tr = Trace(1.0, dev)
    tr.prepare()
    tr.start()
    with torch.profiler.record_function(STEP):
        for _ in range(4):
            engram_gated_fuse(h, e, wg, wp)
            gather_rows_multi([table], gid)
    tr.stop()
    a = analyse(tr.events)
    assert a["marker_found"]
    assert a["busy_ns"] > 0
    for op in ("repro_torch::gated_fuse", "repro_torch::engram_gather"):
        calls = a["op_calls"][op]
        assert len(calls) == 4
        assert all(ns > 0 for _, ns in calls)
    assert a["op_calls"]["repro_torch::gated_fuse"][0][0][:2] == \
        [[8, 1, d], [8, 1, F]]
