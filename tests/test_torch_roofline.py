"""PyTorch port vs the JAX reference: the roofline tooling
(``repro_torch.roofline``), on the CPU.

* ``model_flops`` equals the reference's to 1e-12 relative for every
  arch x ``applicable_shapes``; ``roofline(hw=<the reference's HW>)`` gives
  the reference's terms, bound and fraction; the port's ``HW`` is the
  H100's.
* ``collective_stats`` on recorded calls equals the reference's on
  tests/test_roofline.py's HLO (all-reduce, all-gather, reduce-scatter,
  all-to-all, collective-permute). The same calls recorded by the
  counting mode from c10d operations are in tests/test_torch_dryrun.py
  (they need a process group, so a subprocess).
* The counting mode's rules on torch analogues of tests/test_hlo_scale.py's
  cases: matmul FLOPs counted by hand, every iteration of a loop counted
  (eager execution's trip count), views free, an in-place slice write
  charged the slice, ``index_select`` charged the rows, an expanded
  operand its distinct elements; K1 and K2 through their shape functions
  on meta tensors, charged their bounds' numerators, launching nothing.
* A sampled scan (``models.loops.trips`` under
  ``counting.sample_loops``, on fake tensors) counts what the whole scan
  counts: exactly in a forward pass, and the FLOPs exactly and the bytes
  within ``SAMPLED_BYTES_TOL`` in a train step of reduced jamba and xLSTM
  (the sums of a gradient across positions run in the context of the
  position that arrives second, so one position's worth goes unscaled);
  at S = 256 and 1024 (one scan layer) the bytes and the transient
  memory within ``SAMPLED_BYTES_TOL`` too (the storages a sampled scan
  leaves alive counted for the positions not run); a train step's bytes
  at S = 1024 within 4.5x of S = 256's (the scans' backward linear), and
  so the bytes that assemble chunked attention's q, k and v gradients
  (each split into its blocks once, F16).
  Over real tensors a sampler changes nothing: every iteration runs and
  the answer is bit-equal; a mode that samples refuses a real operand.
* On one device the port's ``flops_dot`` against the reference's
  ``scaled_stats`` of the compiled HLO for reduced engram-27b: prefill
  and decode equal (within 5 %, the bound set, and in fact to 1e-9),
  the train step (with and without remat) within 5 % (0.3 % measured:
  the port's optimizer counts a few more dot products).
"""
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.launch.train import reduced_config as ref_reduced  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.transformer import RunFlags as RefFlags  # noqa: E402
from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro.roofline.hlo_scale import scaled_stats  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.engram_gather import (gather_rows,  # noqa: E402
                                               gather_rows_multi)
from repro_torch.kernels.gated_fuse import engram_gated_fuse  # noqa: E402
from repro_torch.launch.train import reduced_config  # noqa: E402
from repro_torch.models import loops  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.params import from_jax  # noqa: E402
from repro_torch.models.transformer import RunFlags  # noqa: E402
from repro_torch.roofline import analysis, counting  # noqa: E402
from repro_torch.train.loop import build_train_step, value_and_grad  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_opt_state  # noqa: E402

# a sampled scan's bytes in a train step, as a share of the whole scan's
# (measured 4.7 % on reduced jamba and on reduced xLSTM in bf16 at S = 24,
# k = 3: the sums of gradients across positions, which shrink as 1/k)
SAMPLED_BYTES_TOL = 0.1

ARCH_SHAPES = [(a, s) for a in ref_base.list_archs()
               for s in ref_base.applicable_shapes(ref_base.get_config(a))]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,shape", ARCH_SHAPES,
                         ids=[f"{a}-{s}" for a, s in ARCH_SHAPES])
def test_model_flops_match_reference(arch, shape):
    want = ref_analysis.model_flops(ref_base.get_config(arch),
                                    ref_base.SHAPES[shape])
    got = analysis.model_flops(configs.get_config(arch),
                               configs.SHAPES[shape])
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("terms", [(197e12, 819e9, 0.0), (1e12, 1e9, 500e9),
                                   (3.1e14, 2.2e12, 4.0e10),
                                   (0.0, 0.0, 0.0)])
def test_roofline_terms_match_reference(terms):
    want = ref_analysis.roofline(*terms, hw=ref_analysis.HW)
    got = analysis.roofline(*terms, hw=ref_analysis.HW)
    for k in ("compute_s", "memory_s", "collective_s", "step_time_s",
              "roofline_fraction"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-15)
    assert got.bound == want.bound


def test_hw_is_the_h100():
    assert analysis.HW["peak_flops"] == 989e12
    assert analysis.HW["hbm_bw"] == 3.35e12
    assert analysis.HW["link_bw"] == 450e9
    assert analysis.HW["hbm_per_chip"] == 80e9
    r = analysis.roofline(989e12, 3.35e12, 450e9)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 1.0)


REF_HLO = """
ENTRY %main {
  %ar = f32[1024,256]{1,0} all-reduce(f32[1024,256]{1,0} %x), replica_groups=[16,16]<=[256]
  %ag = bf16[64,128]{1,0} all-gather(bf16[8,128]{1,0} %y), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %rs = f32[8,128]{1,0} reduce-scatter(f32[64,128]{1,0} %z), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %a2a = f32[16,32]{1,0} all-to-all(f32[16,32]{1,0} %w), replica_groups=[16,16]<=[256]
  %cp = u32[4]{0} collective-permute(u32[4]{0} %p), source_target_pairs={{0,1},{1,0}}
}
"""

# the same collectives as (kind, payload bytes, group size) calls
CALLS = [("all-reduce", 1024 * 256 * 4, 16), ("all-gather", 64 * 128 * 2, 8),
         ("reduce-scatter", 8 * 128 * 4, 8), ("all-to-all", 16 * 32 * 4, 16),
         ("collective-permute", 4 * 4, 2)]


def test_collective_stats_match_reference():
    want = ref_analysis.collective_stats(REF_HLO, 256)
    got = analysis.collective_stats(CALLS)
    assert got["counts"] == want["counts"]
    for key in ("wire_bytes_per_device", "payload_bytes_per_device"):
        assert got[key].keys() == want[key].keys()
        for k in want[key]:
            assert got[key][k] == pytest.approx(want[key][k], rel=1e-12)
    assert got["total_wire_bytes_per_device"] == pytest.approx(
        want["total_wire_bytes_per_device"], rel=1e-12)


def _count(fn, *args, sample=None):
    """(fn's result, the counting mode's stats of the call); ``sample``:
    the call's loops sampled to that many iterations after the first."""
    mode = counting.CountingMode()
    with mode, (counting.sample_loops(mode, sample) if sample
                else contextlib.nullcontext()):
        out = fn(*args)
    return out, mode.stats()


def _faked(tree):
    """(a FakeTensorMode, ``tree`` with every tensor a fake of it)."""
    fm = FakeTensorMode()
    return fm, tree_map(lambda t: fm.from_tensor(t)
                        if isinstance(t, torch.Tensor) else t, tree)


def _stats(fn, *args, **kw):
    return _count(fn, *args, **kw)[1]


def test_matmul_flops_counted_by_hand():
    a, b = torch.randn(64, 48), torch.randn(48, 32)
    assert _stats(torch.mm, a, b)["flops_dot"] == 2 * 64 * 48 * 32
    bias = torch.randn(32)
    assert _stats(torch.nn.functional.linear, a, b.t(), bias)[
        "flops_dot"] == 2 * 64 * 48 * 32
    x, y = torch.randn(3, 5, 7), torch.randn(3, 7, 11)
    assert _stats(torch.bmm, x, y)["flops_dot"] == 2 * 3 * 5 * 7 * 11
    assert _stats(torch.einsum, "bij,bjk->bik", x, y)[
        "flops_dot"] == 2 * 3 * 5 * 7 * 11
    assert _stats(torch.mv, a, torch.randn(48))["flops_dot"] == 2 * 64 * 48
    # elementwise work is not counted, as in the reference
    assert _stats(torch.exp, a)["flops_dot"] == 0


def test_every_iteration_of_a_loop_counts():
    """tests/test_hlo_scale.py's while loop of 12 dots: eager execution
    runs, and counts, each one."""
    p = torch.randn(64, 64)

    def body(x):
        for _ in range(12):
            x = x @ x
        return x
    st = _stats(body, p)
    assert st["flops_dot"] == 12 * 2 * 64 ** 3
    assert st["bytes_accessed"] == 12 * 3 * 64 * 64 * 4


def test_views_are_free():
    x = torch.randn(16, 32)

    def views(x):
        return x.view(32, 16), x.t(), x[2:5], x.unsqueeze(0), x.reshape(-1)
    st = _stats(views, x)
    assert st["bytes_accessed"] == 0 and st["n_ops"] > 0


def test_inplace_slice_write_charged_the_update():
    """The dynamic-update-slice rule: writing one row of a 1024 x 8 buffer
    (a KV-cache write) costs the row and its index, not the buffer."""
    buf, upd = torch.zeros(1024, 8), torch.randn(1, 8)
    rows = torch.tensor([5])
    for write in (lambda: buf.index_copy_(0, rows, upd),
                  lambda: buf.index_put_((rows,), upd),
                  lambda: buf[5:6].copy_(upd)):
        st = _stats(write)
        assert 8 * 4 <= st["bytes_accessed"] < 1024 * 8 * 4
    assert _stats(lambda: buf[5:6].copy_(upd))["bytes_accessed"] == 2 * 8 * 4
    assert _stats(lambda: buf.index_copy_(0, rows, upd))[
        "bytes_accessed"] == 8 * 4 + 8


def test_gather_charged_the_rows_read():
    """The gather rule: 16 rows of a 10000-row table cost the rows read
    and written and the ids, not the table."""
    table, idx = torch.randn(10000, 64), torch.randint(0, 10000, (16,))
    want = 2 * 16 * 64 * 4 + 16 * 8
    assert _stats(torch.index_select, table, 0, idx)[
        "bytes_accessed"] == want
    assert _stats(lambda: table[idx])["bytes_accessed"] == want
    assert _stats(torch.nn.functional.embedding, idx, table)[
        "bytes_accessed"] == want


def test_expanded_operand_charged_its_elements():
    x, col = torch.randn(64, 128), torch.randn(64, 1)
    st = _stats(lambda: x * col.expand(64, 128))
    assert st["bytes_accessed"] == (2 * 64 * 128 + 64) * 4


def test_kernels_counted_through_their_shape_functions():
    """K1 and K2 on meta tensors: one custom operator each, charged the
    numerators of their bounds, no launch and no module cache touched."""
    from repro_torch.kernels.engram_gather import ops as k1_ops
    from repro_torch.kernels.gated_fuse import ops as k2_ops
    k1_before, k2_before = gather_rows.launches, engram_gated_fuse.launches
    tables = [torch.empty(4096, 160, dtype=torch.bfloat16, device="meta")
              for _ in range(2)]
    gid = torch.empty(2, 128, dtype=torch.int64, device="meta")
    out, st = _count(gather_rows_multi, tables, gid)
    assert (tuple(out.shape), out.dtype, out.device.type) == (
        (2, 128, 160), torch.bfloat16, "meta")
    assert st["kernel_calls"] == {counting.K1: 1}
    assert st["bytes_accessed"] == 2 * (2 * 128 * 320 + 8 * 128)
    assert st["flops_dot"] == 0
    T, d, F = 8, 512, 256
    h = torch.empty(T, d, dtype=torch.bfloat16, device="meta")
    e = torch.empty(T, F, dtype=torch.bfloat16, device="meta")
    wg = torch.empty(d, d, dtype=torch.bfloat16, device="meta")
    wp = torch.empty(F, d, dtype=torch.bfloat16, device="meta")
    with torch.no_grad():
        out, st = _count(engram_gated_fuse, h, e, wg, wp)
    assert (tuple(out.shape), out.device.type) == ((T, d), "meta")
    assert st["kernel_calls"] == {counting.K2: 1}
    assert st["flops_dot"] == 2 * T * d * (d + F)
    assert st["bytes_accessed"] == 2 * (2 * T * d + T * F + d * d + F * d)
    assert (gather_rows.launches, engram_gated_fuse.launches) == (
        k1_before, k2_before)
    assert k2_ops._COUNTERS == {} and k1_ops._FN is None


def test_live_bytes_track_storages():
    mem = counting.LiveBytes()
    a = torch.empty(1000)
    assert mem.hold(a) == 4000 and mem.hold(a[10:20]) == 0
    b = torch.empty(500)
    mem.hold(b)
    assert (mem.current, mem.peak) == (6000, 6000)
    del a
    assert mem.current == 2000 and mem.peak == 6000


def _scan(x, A, n):
    h, ys = torch.zeros(2, 8, 4, device=x.device), []
    for t in loops.trips(0, n, x):
        h = torch.exp(x[:, t, :, None] * A) * h + x[:, t, :, None]
        ys.append(torch.einsum("bdn,n->bd", h, A[0]))
    return loops.stack_positions(ys, n, dim=1)


def test_sampled_scan_counts_the_whole_scan_forward():
    fm, (x, A) = _faked((torch.randn(2, 64, 8), torch.randn(8, 4)))
    with fm:
        full = _stats(_scan, x, A, 64)
        out, samp = _count(_scan, x, A, 64, sample=4)
    assert tuple(out.shape) == (2, 64, 8)
    assert samp["sampled_loops"] == 1 and full["sampled_loops"] == 0
    assert samp["flops_dot"] == full["flops_dot"]
    assert samp["bytes_accessed"] == pytest.approx(full["bytes_accessed"],
                                                   rel=1e-12)


def test_sampler_leaves_real_loops_whole():
    x, A = torch.randn(2, 64, 8), torch.randn(8, 4)
    want = _scan(x, A, 64)
    seen = []

    class Sampler:
        k = 4

        @contextlib.contextmanager
        def loop(self, n):
            seen.append(n)
            yield

    with loops.sampling(Sampler()):
        got = _scan(x, A, 64)
        assert list(loops.trips(0, 64, x)) == list(range(64))
        assert len(list(loops.trips(0, 64, x.to("meta")))) == 5
    assert seen == [64]
    assert torch.equal(got, want)


def test_sampling_mode_refuses_real_tensors():
    mode = counting.CountingMode()
    with mode, counting.sample_loops(mode, 4):
        with pytest.raises(RuntimeError, match="fake or meta"):
            torch.randn(3, 4) @ torch.randn(4, 2)
        torch.randn(3, 4, device="meta") * torch.tensor(2.0)   # a scalar
    torch.randn(3, 4) @ torch.randn(4, 2)      # a mode done sampling


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_sampled_scan_counts_a_train_step(arch):
    # on the meta device: the card's path (the CPU's MoE reads its group
    # offsets on the host, which no trace can), in the card's bf16
    cfg = dataclasses.replace(reduced_config(arch), dtype="bfloat16")
    tok = torch.randint(1, cfg.vocab_size, (2, 24))
    loss_fn = port_model.build_loss_fn(cfg, RunFlags())
    params, batch = tree_map(lambda t: t.to("meta"), (
        port_model.init_params(cfg, 0, "cpu"), {"tokens": tok, "labels": tok}))
    full = _stats(value_and_grad, loss_fn, params, batch)
    samp = _stats(value_and_grad, loss_fn, params, batch, sample=3)
    assert samp["sampled_loops"] > 0 and full["sampled_loops"] == 0
    assert samp["flops_dot"] == pytest.approx(full["flops_dot"], rel=1e-9)
    share = abs(samp["bytes_accessed"] / full["bytes_accessed"] - 1)
    print(f"{arch}: sampled train step bytes {share:.4f} from the whole "
          f"scan's, FLOPs {samp['flops_dot'] / full['flops_dot'] - 1:.2e}")
    assert share < SAMPLED_BYTES_TOL


def _train_trace(cfg, S, sample=None, remat=False):
    """``cfg``'s train step (bf16, B = 2) on the meta device at sequence
    length ``S``: the counting mode's stats with ``transient``, the
    ``LiveBytes`` peak less the arguments."""
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    tok = torch.randint(1, cfg.vocab_size, (2, S))
    loss_fn = port_model.build_loss_fn(cfg, RunFlags(remat=remat))
    params, batch = tree_map(lambda t: t.to("meta"), (
        port_model.init_params(cfg, 0, "cpu"), {"tokens": tok, "labels": tok}))
    mem = counting.LiveBytes()
    for t in tree_leaves((params, batch)):
        mem.hold(t)
    args = mem.current
    mode = counting.CountingMode(memory=mem)
    with mode, (counting.sample_loops(mode, sample) if sample
                else contextlib.nullcontext()):
        value_and_grad(loss_fn, params, batch)
    return dict(mode.stats(), transient=mem.peak - args)


def _one_mixer(arch):
    """Reduced ``arch`` cut to one layer of its scan's mixer (Mamba; mLSTM),
    without Engram: a whole trace at S = 1024 in seconds."""
    cfg = reduced_config(arch)
    i = cfg.layer_types.index("mamba" if arch.startswith("jamba")
                              else "mlstm")
    return dataclasses.replace(
        cfg, n_layers=1, layer_types=cfg.layer_types[i:i + 1],
        ffn_types=cfg.ffn_types[i:i + 1], attn_kinds=cfg.attn_kinds[i:i + 1],
        engram=None)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
@pytest.mark.parametrize("S", [256, 1024])
def test_sampled_scan_counts_a_long_train_step(arch, S):
    """At S = 256 and 1024 a train step's sampled trace counts the whole
    trace's bytes, and its transient memory (peak less arguments), within
    ``SAMPLED_BYTES_TOL``: the storages a sampled scan leaves alive (the
    states autograd keeps, one set per position) are counted for the
    positions not run. (A remat period's recompute in the backward is
    counted as run: ``launch.dryrun`` says so in the record.)"""
    cfg = _one_mixer(arch)
    full = _train_trace(cfg, S)
    samp = _train_trace(cfg, S, sample=4)
    assert samp["sampled_loops"] > 0 and full["sampled_loops"] == 0
    for key in ("bytes_accessed", "transient"):
        share = abs(samp[key] / full[key] - 1)
        print(f"{arch} S={S}: sampled {key} {share:.2e} from the whole's")
        assert share < SAMPLED_BYTES_TOL, key


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_scan_backward_bytes_grow_linearly(arch):
    """Reduced ``arch``'s train step (remat) counts within 4.5x the bytes at
    S = 1024 that it counts at S = 256: the scans' backward is linear in
    the sequence length (each input is unbound into its positions once, so
    one backward stacks their gradients)."""
    cfg = reduced_config(arch)
    ratio = _train_trace(cfg, 1024, sample=4, remat=True)[
        "bytes_accessed"] / _train_trace(cfg, 256, sample=4, remat=True)[
            "bytes_accessed"]
    print(f"{arch}: bytes at S=1024 over S=256: {ratio:.3f}")
    assert ratio < 4.5


class _QKVGradBytes(counting.CountingMode):
    """A ``CountingMode`` that also sums the bytes of the ops that write a
    tensor of q, k or v's whole (B, S, H, D) shape by cat or by a slice's
    backward (what assembles their gradients from per-block pieces), and
    keeps the shapes every ``slice_backward`` wrote."""

    def __init__(self, whole):
        super().__init__()
        self.whole, self.assembly, self.slice_shapes = whole, 0.0, []

    def _account(self, func, args, kwargs, out):
        before = self.bytes
        super()._account(func, args, kwargs, out)
        name = func._schema.name
        if name == "aten::slice_backward":
            self.slice_shapes.append(tuple(out.shape))
        if name in ("aten::slice_backward", "aten::cat") and \
                tuple(out.shape[:2]) == self.whole and out.dim() == 4:
            self.assembly += self.bytes - before


def _chunked_train_trace(S):
    """Reduced deepseek-7b without Engram, bf16, B = 2, remat, 64-position
    attention blocks (``chunk_threshold=64``): its train step on the meta
    device, loops sampled as the dry run samples them."""
    cfg = dataclasses.replace(reduced_config("deepseek-7b"), engram=None,
                              dtype="bfloat16")
    flags = RunFlags(remat=True, chunk_threshold=64, q_chunk=64,
                     kv_chunk=64)
    tok = torch.randint(1, cfg.vocab_size, (2, S))
    params, batch = tree_map(lambda t: t.to("meta"), (
        port_model.init_params(cfg, 0, "cpu"), {"tokens": tok, "labels": tok}))
    mode = _QKVGradBytes((2, S))
    with mode, counting.sample_loops(mode, 4):
        value_and_grad(port_model.build_loss_fn(cfg, flags), params, batch)
    return mode


def test_chunk_attention_backward_bytes_grow_linearly():
    """F16: chunked attention splits q, k and v into their blocks once, so
    no ``slice_backward`` writes a whole-size (B, S, H, D) zero gradient
    per block pair, and the bytes of the ops that assemble q, k and v's
    gradients grow at most 4.5x from S = 256 to S = 1024 (38.3x when each
    block pair sliced them); the split's backward gives the dense path's
    gradients."""
    import math
    from repro_torch.models.attention import _chunk_attn, _mask, _sdpa
    modes = {S: _chunked_train_trace(S) for S in (256, 1024)}
    for S, mode in modes.items():
        assert mode.assembly > 0
        assert not [s for s in mode.slice_shapes if s[:2] == (2, S)], S
    ratio = modes[1024].assembly / modes[256].assembly
    print(f"q/k/v gradient assembly bytes at S=1024 over S=256: {ratio:.3f}")
    assert ratio <= 4.5
    cfg = reduced_config("deepseek-7b")
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 40, h, 16, generator=g, requires_grad=True)
               for h in (4, 2, 2))
    pos = torch.arange(40)
    w = torch.randn(2, 40, 4, 16, generator=g)
    grads = []
    for chunked in (True, False):
        out = _chunk_attn(cfg, q, k, v, pos, pos, q_chunk=16, kv_chunk=8) \
            if chunked else _sdpa(cfg, q, k, v,
                                  _mask(pos, pos, causal=True)[None])
        grads.append(torch.autograd.grad((out * w).sum(), (q, k, v)))
    for a, b in zip(*grads):
        assert math.isclose(float((a - b).abs().max()), 0.0, abs_tol=1e-5)


@pytest.fixture(scope="module")
def engram27b():
    rcfg, cfg = ref_reduced("engram-27b"), reduced_config("engram-27b")
    rp = ref_model.init_params(rcfg, 0)
    pp = from_jax(jax.tree.map(np.asarray, rp), cfg, "cpu")
    tok = np.random.RandomState(0).randint(1, cfg.vocab_size,
                                           (2, 32)).astype(np.int32)
    return rcfg, cfg, rp, pp, tok


def _rel(got, want):
    return abs(got / want - 1)


def test_flops_dot_match_xla_prefill_and_decode(engram27b):
    rcfg, cfg, rp, pp, tok = engram27b
    B, S = tok.shape
    txt = jax.jit(ref_model.build_prefill_step(rcfg, RefFlags(), max_len=S)
                  ).lower(rp, {"tokens": jnp.asarray(tok)}).compile().as_text()
    want = scaled_stats(txt, 1)["flops_dot"]
    got = _stats(port_model.build_prefill_step(cfg, RunFlags(), max_len=S),
                 pp, {"tokens": torch.from_numpy(tok)})["flops_dot"]
    print(f"prefill: port {got:.0f}, XLA {want:.0f}")
    assert _rel(got, want) <= 0.05 and _rel(got, want) < 1e-9
    rs = ref_model.init_decode_state(rcfg, RefFlags(), B, S)
    txt = jax.jit(ref_model.build_decode_step(rcfg, RefFlags())).lower(
        rp, rs, jnp.asarray(tok[:, 0])).compile().as_text()
    want = scaled_stats(txt, 1)["flops_dot"]
    ps = port_model.init_decode_state(cfg, RunFlags(), B, S, "cpu")
    got = _stats(port_model.build_decode_step(cfg, RunFlags()), pp, ps,
                 torch.from_numpy(tok[:, 0]))["flops_dot"]
    print(f"decode: port {got:.0f}, XLA {want:.0f}, gap {got / want - 1:.2e}")
    assert _rel(got, want) < 1e-9


@pytest.mark.parametrize("remat", [False, True])
def test_flops_dot_match_xla_train(engram27b, remat):
    rcfg, cfg, rp, pp, tok = engram27b
    loss_fn = ref_model.build_loss_fn(rcfg, RefFlags(remat=remat))
    oc = ref_opt.AdamWConfig()

    def train_step(params, opt, batch):
        _, g = jax.value_and_grad(loss_fn)(params, batch)
        return ref_opt.adamw_update(oc, params, g, opt)

    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    txt = jax.jit(train_step).lower(rp, ref_opt.init_opt_state(rp),
                                    batch).compile().as_text()
    want = scaled_stats(txt, 1)["flops_dot"]
    step = build_train_step(cfg, RunFlags(remat=remat), AdamWConfig())
    t = torch.from_numpy(tok).long()
    got = _stats(step, pp, init_opt_state(pp), {"tokens": t, "labels": t})[
        "flops_dot"]
    print(f"train (remat {remat}): port {got:.0f}, XLA {want:.0f}, gap "
          f"{got / want - 1:.2e}")
    assert _rel(got, want) <= 0.05
