"""K3, the decode-attention kernel's CPU side (``repro_torch.kernels.
decode_attn``): its plain version against ``models.attention``'s plain
decode route, its shape function on meta tensors (the operator by name,
no launch), and its charge in ``roofline.counting``.

* ``decode_attention_ref`` (the kernel's plain version, written apart
  from ``_sdpa``) against ``attention.decode_attention``'s CPU route over
  head dims 8 to 256, g 1, 5 and 8, f32 and bf16 caches, a global and a
  local layer with a softcap, and ragged positions (0, S - 1, past S, -1):
  the caches bit-equal (the new rows where ``write_rows`` puts them), the
  outputs within ``TOL``; and under a mesh plan whose query heads do not
  start a KV group (``q_offset``) against ``kv_for_queries``' heads.
* On meta tensors the wrapper passes through ``repro_torch::
  decode_attention``'s shape function: the output's shape and dtype, no
  launch, no module cache touched; operands it does not take raise.
* ``CountingMode`` charges one call ``ops.cost`` over the keys the shapes
  allow (the cache's length or the window), on a bare call and in a
  model's decode step traced on the meta device: one call a GQA layer.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attn import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attn import ops as k3_ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.roofline import counting  # noqa: E402

# f32: the same f32 products summed in another order; bf16: the plain
# route rounds the softmax's weights to bf16 (2^-9 relative each) before
# the value product and the plain version keeps them f32, so an output
# moves by up to 2^-9 of sum(p |v|), about 1 with unit-normal values,
# beside a bf16 ulp of its own rounding: an output near zero (values
# cancelling) parts by up to 2^-8 absolute
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2.0 ** -6, atol=2.0 ** -7)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _operands(B, S, Hkv, Hq, D, dtype, pos, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.randn(*s).astype(np.float32)).to(dtype)
    return (mk(B, Hq, D), mk(B, Hkv, D), mk(B, Hkv, D), mk(B, S, Hkv, D),
            mk(B, S, Hkv, D), torch.tensor(pos, dtype=torch.int32))


def _plain(ops, g, window, softcap, plan=None):
    """``attention.plain_decode`` (the CPU route of ``decode_attention``
    after its projections) on copies of the operands: output, caches."""
    q, kn, vn, kc, vc, pos = (t.clone() for t in ops)
    cfg = SimpleNamespace(n_heads=g, n_kv_heads=1, attn_logit_softcap=softcap)
    out = attention.plain_decode(cfg, q[:, None], kn[:, None], vn[:, None],
                                 kc, vc, pos, window, plan=plan)[:, 0]
    return out, kc, vc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["global", "local_softcap"])
@pytest.mark.parametrize("g", [1, 5, 8])
@pytest.mark.parametrize("D", [8, 16, 64, 128, 256])
def test_plain_version_matches_the_cpu_route(D, g, kind, dtype):
    B, S, Hkv = 6, 40, 2
    window, softcap = (0, 0.0) if kind == "global" else (7, 50.0)
    pos = [0, S - 1, S + 2, -1, 11, 23]
    if window:
        pos[2] = S + window + 1          # past S + window: no valid key
    ops = _operands(B, S, Hkv, g * Hkv, D, dtype, pos, seed=D + g)
    want, kc_p, vc_p = _plain(ops, g, window, softcap)
    q, kn, vn, kc, vc, p = (t.clone() for t in ops)
    got = decode_attention(q, kn, vn, kc, vc, p, window=window,
                           softcap=softcap, group=g)
    assert got.dtype == dtype and got.shape == (B, g * Hkv, D)
    assert torch.equal(kc, kc_p) and torch.equal(vc, vc_p)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("h0,h1,c0,c1", [(3, 7, 0, 2), (5, 10, 1, 2),
                                         (0, 10, 0, 2)])
def test_plain_version_reads_a_plans_heads(h0, h1, c0, c1):
    """Query heads [h0, h1) of g = 5 over a cache block of KV heads [c0,
    c1): with ``q_offset = h0 - c0 g`` the plain version reads the heads
    ``kv_for_queries`` gives the plain route (expanded one per query head
    where h0 does not start a group)."""
    g = 5
    plan = attention.HeadPlan(h0, h1, h0 // g, -(-h1 // g), c0, c1, {}, (),
                              h0 % g == 0 and h1 % g == 0)
    ops = _operands(3, 24, c1 - c0, h1 - h0, 16, torch.float32, [5, 23, 30])
    want, kc_p, vc_p = _plain(ops, g, 0, 0.0, plan)
    q, kn, vn, kc, vc, p = (t.clone() for t in ops)
    got = decode_attention(q, kn, vn, kc, vc, p, group=g,
                           q_offset=h0 - c0 * g)
    assert torch.equal(kc, kc_p) and torch.equal(vc, vc_p)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


def test_decode_attention_cpu_route_unchanged():
    """``attention.decode_attention`` on CPU tensors runs the plain route
    and launches nothing."""
    from repro_torch.configs import gemma2_27b
    from repro_torch.models.model import init_params
    cfg = gemma2_27b.reduced()
    p = init_params(cfg, seed=0, device="cpu")["segments"][0][0]["mixer"]
    B, S = 3, 24
    cache = attention.init_kv_cache(cfg, B, S, torch.float32, "cpu")
    h = torch.randn(B, 1, cfg.d_model)
    pos = torch.tensor([0, 9, 30])
    before = decode_attention.launches
    out, cache2 = attention.decode_attention(cfg, p, h, cache, pos, "local")
    assert out.shape == (B, 1, cfg.d_model) and cache2 is cache
    assert decode_attention.launches == before
    q, k, v = attention._qkv(cfg, p, h, pos[:, None], "local")
    kc = torch.zeros_like(cache["k"])
    vc = torch.zeros_like(cache["v"])
    want = attention.plain_decode(cfg, q, k, v, kc, vc, pos,
                                  cfg.window_size)
    torch.testing.assert_close(out, attention._out(
        None, p["wo"], want, cfg.head_dim), rtol=0, atol=0)
    assert torch.equal(cache["k"], kc) and torch.equal(cache["v"], vc)


def _meta(B, S, Hc, Hq, D, dtype=torch.bfloat16):
    mk = lambda *s: torch.empty(*s, dtype=dtype, device="meta")  # noqa: E731
    return (mk(B, Hq, D), mk(B, Hc, D), mk(B, Hc, D), mk(B, S, Hc, D),
            mk(B, S, Hc, D), torch.empty(B, dtype=torch.int32,
                                         device="meta"))


def _count(fn, *args, **kw):
    mode = counting.CountingMode()
    with torch.no_grad(), mode:
        out = fn(*args, **kw)
    return out, mode.stats()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window,q_offset", [(0, 0), (100, 0), (5000, 3)])
def test_meta_call_is_the_operator_charged_its_cost(dtype, window,
                                                    q_offset):
    """On meta tensors: the shape function's output, one call of the
    operator by name, charged ``cost`` over min(S, window) keys a row (S
    on a global layer), no launch and no module cache touched."""
    B, S, Hc, g, D = 4, 4608, 8, 5, 128
    Hq = g * Hc - q_offset
    before = decode_attention.launches
    out, st = _count(decode_attention, *_meta(B, S, Hc, Hq, D, dtype),
                     window=window, group=g, q_offset=q_offset)
    assert (tuple(out.shape), out.dtype, out.device.type) == (
        (B, Hq, D), dtype, "meta")
    assert st["kernel_calls"] == {counting.K3: 1}
    keys = min(S, window) if window else S
    n_read = k3_ops.kv_heads_read(Hq, g, q_offset)
    assert n_read == Hc - q_offset // g
    item = torch.finfo(dtype).bits // 8
    assert st["flops_dot"] == 4.0 * Hq * D * B * keys
    assert st["bytes_accessed"] == item * (
        2 * n_read * D * B * keys + 4 * B * Hc * D + 2 * B * Hq * D) + 8 * B
    assert decode_attention.launches == before
    assert k3_ops._COUNTERS == {} and k3_ops._FN is None


@pytest.mark.parametrize("bad", ["head_dim", "group", "dtype", "shape",
                                 "rows"])
def test_operands_it_does_not_take_raise(bad):
    B, S, Hc, g, D = 2, 64, 2, 4, 128
    if bad == "rows":
        ops, kw = _meta(k3_ops.MAX_ROWS + 1, S, Hc, g * Hc, D), dict(group=g)
    elif bad == "head_dim":
        ops, kw = _meta(B, S, Hc, g * Hc, 96), dict(group=g)
    elif bad == "group":
        ops, kw = _meta(B, S, 1, 9, D), dict(group=9)
    elif bad == "dtype":
        ops, kw = _meta(B, S, Hc, g * Hc, D, torch.float16), dict(group=g)
    else:
        ops, kw = _meta(B, S, Hc, g * Hc + 1, D), dict(group=g)
    with pytest.raises(ValueError):
        decode_attention(*ops, **kw)


def test_plan_chunk_fills_the_card():
    """Splits of 512 positions where rows x splits reach 4 x 132 items
    (both benchmark cells), smaller where they would not."""
    assert k3_ops.plan_chunk(32 * 8, 4608) == 512
    assert k3_ops.plan_chunk(8 * 8, 6272) == 512
    assert k3_ops.plan_chunk(8 * 8, 2048) == 128
    assert k3_ops.plan_chunk(8 * 8, 512) == 64
    assert k3_ops.plan_chunk(1, 64) == 64
    assert all(k3_ops.plan_chunk(r, s) in k3_ops.CHUNKS
               for r in (1, 7, 64, 300) for s in (1, 100, 5000))


def test_decode_step_on_meta_calls_the_operator_per_gqa_layer():
    """Reduced gemma2-27b's decode step traced on the meta device: one K3
    call a layer (local and global alike), none under the CPU's route."""
    from repro_torch.configs import gemma2_27b
    from repro_torch.models.model import (build_decode_step,
                                          init_decode_state, init_params)
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer import RunFlags
    cfg = gemma2_27b.reduced()
    flags = RunFlags()
    step = build_decode_step(cfg, flags)
    calls = {}
    params = init_params(cfg, seed=0, device="cpu")
    for dev in ("cpu", "meta"):
        params = tree_map(lambda t: t.to(dev), params)
        state = init_decode_state(cfg, flags, 2, 32, dev)
        token = torch.ones(2, dtype=torch.int32, device=dev)
        calls[dev] = _count(step, params, state, token)[1]["kernel_calls"]
    assert calls["cpu"].get(counting.K3, 0) == 0
    assert calls["meta"][counting.K3] == cfg.n_layers


def test_cost_counts_each_key_once():
    """``cost`` by hand: 2 x 128 query-head products a key for the scores
    and 2 x 128 for the values; K and V of the read heads once."""
    f, b = k3_ops.cost(n_q=40, n_kv_read=8, n_kv=8, d=128, item=2, rows=32,
                       keys=32 * 1227)
    assert f == 4 * 40 * 128 * 32 * 1227
    live = 2 * 8 * 128 * 32 * 1227 * 2
    assert b == live + 2 * (4 * 32 * 8 * 128 + 2 * 32 * 40 * 128) + 8 * 32
    assert math.isclose(live / 3.35e12 * 1e3 * 36, 1.73, rel_tol=0.01)
