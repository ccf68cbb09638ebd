"""The port's CUDA kernels against their plain versions, and the chunked
serving path, on the card.

Marked ``cuda``; each test skips on a machine without a CUDA device (the
kernels have no CPU mode). This file imports nothing of JAX, so it runs on
the GPU machine: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.engram_gather import (engram_gather,  # noqa: E402
                                               engram_gather_ref,
                                               gather_rows, gather_rows_multi,
                                               gather_rows_multi_ref,
                                               gather_rows_ref)
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
def test_gather_rows_multi_kernel_bit_equal():
    """One launch over two tables of different row strides (320 and 336
    bytes), the second offset by 6 bytes, so not 16-byte aligned."""
    dev = _card()
    pair = [torch.randn(900, 160, device=dev).to(torch.bfloat16),
            torch.randn(700, 168, device=dev).to(torch.bfloat16)[:, 3:163]]
    gid = torch.stack([torch.randint(0, t.shape[0], (129,), device=dev)
                       for t in pair])
    before = gather_rows.launches
    got = gather_rows_multi(pair, gid)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_multi_ref(pair, gid))
    aligned = [pair[0], torch.randn(50, 160, device=dev).to(torch.bfloat16)]
    gid = torch.stack([torch.randint(0, 50, (128,), device=dev)] * 2)
    assert torch.equal(gather_rows_multi(aligned, gid),
                       gather_rows_multi_ref(aligned, gid))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,F", [(5120, 2560), (100, 36)])
@pytest.mark.parametrize("T", [1, 8, 13, 64, 65, 256])
def test_gated_fuse_kernel_split_deterministic(dtype, T, d, F):
    """The bf16 kernel's split contraction (and the f32 kernel): within one
    bf16 ulp or f32 tolerance of the plain version, and bit-identical
    across two calls (partials summed in part order, no float atomics)."""
    dev = _card()
    rng = np.random.RandomState(T)
    ops = [torch.from_numpy(a).to(dev, TORCH_DTYPES[dtype]) for a in (
        rng.randn(T, d), rng.randn(T, F), rng.randn(d, d) / np.sqrt(d),
        rng.randn(F, d) / np.sqrt(F))]
    first = engram_gated_fuse(*ops)
    second = engram_gated_fuse(*ops)
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(first.float(), gated_fuse_ref(*ops).float(),
                               **tol)
    assert torch.equal(first, second)


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


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2100, 2112])
def test_gated_fuse_kernel_long_prompt(T):
    """K2 at a long prompt's prefill shape (2100 tokens, and the 2112 of
    its 32-token bucket) at engram-27b's width, bf16: within one bf16 ulp
    of the plain version and bit-identical across two calls."""
    dev = _card()
    d, F = 5120, 2560
    rng = np.random.RandomState(T)
    ops = [torch.from_numpy(a).to(dev, torch.bfloat16) for a in (
        rng.randn(T, d), rng.randn(T, F), rng.randn(d, d) / np.sqrt(d),
        rng.randn(F, d) / np.sqrt(F))]
    before = engram_gated_fuse.launches
    first = engram_gated_fuse(*ops)
    second = engram_gated_fuse(*ops)
    torch.cuda.synchronize()
    assert engram_gated_fuse.launches == before + 2
    torch.testing.assert_close(first.float(), gated_fuse_ref(*ops).float(),
                               **BF16_TOL)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_chunked_engine_with_prefix_cache_card_equals_cpu():
    """Reduced engram-27b (f32), pool CXL, chunked admission with a prefix
    cache, at the emulated operating point (stalls independent of host
    step times): the card (kernels) emits the CPU's (plain versions)
    streams, with the same prefix hits, StoreStats and PrefixCacheStats."""
    import dataclasses

    from repro_torch.configs import engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.pool.cache import PrefixKVCache
    from repro_torch.serving import Engine
    dev = _card()
    cfg = engram_27b.reduced()
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(7)
    head = [int(t) for t in rng.randint(1, cfg.vocab_size, size=16)]
    prompts = [head + [int(t) for t in rng.randint(1, cfg.vocab_size,
                                                   size=n)]
               for n in (3, 10, 6)]
    seen = []
    for device, p in (("cpu", params),
                      (dev, tree_map(lambda t: t.to(dev), params))):
        eng = Engine(cfg, params=p, pool="CXL", max_batch=2, max_len=64,
                     prompt_bucket=8, prefill_chunk=8,
                     prefix_cache=PrefixKVCache(64 << 20, 8),
                     emulate_step_s=5e-5, device=device)
        first = eng.submit(prompts[0], max_new=6)
        eng.run()
        rest = [eng.submit(q, max_new=6) for q in prompts[1:]]
        eng.run()
        seen.append(([eng.done[r].out for r in [first] + rest],
                     eng.stats.prefix_hit_blocks,
                     dataclasses.asdict(eng.store.stats()),
                     dataclasses.asdict(eng.prefix_cache.stats())))
    assert seen[0] == seen[1]
    assert seen[1][1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True])
def test_spec_engine_card_equals_cpu(pipeline):
    """Reduced engram-27b (f32), pool CXL at the emulated operating point,
    speculative decoding with the n-gram proposer on repeated prompts: the
    card (one K1 launch per verify wave) emits the CPU's streams, which are
    the non-speculative engine's, with the same speculation counters and
    StoreStats."""
    import dataclasses

    from repro_torch.configs import SpecConfig, engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Engine
    dev = _card()
    cfg = engram_27b.reduced()
    params = init_params(cfg, seed=0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params)
    rng = np.random.RandomState(8)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
               for n in (4, 9, 6)] * 2
    seen = []
    for device, p, sp in (("cpu", params, SpecConfig(pipeline=pipeline)),
                          (dev, params_dev, SpecConfig(pipeline=pipeline)),
                          (dev, params_dev, None)):
        eng = Engine(cfg, params=p, pool="CXL", max_batch=3, max_len=64,
                     prompt_bucket=8, emulate_step_s=5e-5, spec=sp,
                     device=device)
        before = gather_rows.launches
        rids = [eng.submit(q, max_new=10) for q in prompts]
        eng.run()
        st = eng.stats
        seen.append(([eng.done[r].out for r in rids],
                     (st.spec_waves, st.accepted_tokens, st.pipelined_hits,
                      st.d2h_pulls),
                     dataclasses.asdict(eng.store.stats()),
                     gather_rows.launches - before))
    cpu, card, plain = seen
    assert card[:3] == cpu[:3]
    assert card[0] == plain[0]
    assert card[1][1] > 0                     # some drafts accepted
    assert cpu[3] == 0 and card[3] == card[1][0]   # K1 once per verify wave


def _links(clock):
    """Clock ledgers with per-object link names (``cache:<id>``) cut."""
    st = clock.stats()
    links = sorted((dict(v, name=n.split(":")[0]) for n, v in
                    st["links"].items()), key=lambda d: d["name"])
    return dict(st, links=links)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["preempt", "idle_spill"])
def test_overload_engine_card_equals_cpu(mode):
    """Reduced engram-27b (f32), pool CXL at the emulated operating point
    with a TinyLFU hot-row cache: preemption under an OverloadPolicy and a
    PoolArbiter (4 batch requests, 2 interactive ones after decode wave
    3), and idle spill (6 requests into 3 slots). The card parks the KV
    of a running slot on the host and restores it, perhaps into another
    slot, and emits the CPU's streams, which are the runs' without
    overload options, with the same counters, KVPoolStats, StoreStats,
    cache and clock; K1 launches once per decode wave."""
    import dataclasses

    from repro_torch.configs import StoreConfig, engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.pool import PoolArbiter
    from repro_torch.serving import Engine, OverloadPolicy
    dev = _card()
    cfg = engram_27b.reduced()
    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=2048, admission="tinylfu")))
    params = init_params(cfg, seed=0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params)
    rng = np.random.RandomState(9)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
               for n in (6, 11, 4, 9, 7, 5)]
    if mode == "preempt":
        kw = dict(max_batch=4, slo_policy=OverloadPolicy(),
                  arbiter=PoolArbiter(kv_cache_share=0.25))
    else:
        kw = dict(max_batch=3, idle_spill_tokens=3)
    seen = []
    for device, p, over in (("cpu", params, True), (dev, params_dev, True),
                            (dev, params_dev, False)):
        eng = Engine(ccfg, params=p, pool="CXL", max_len=64,
                     prompt_bucket=8, emulate_step_s=5e-5, device=device,
                     **(kw if over else dict(max_batch=kw["max_batch"])))
        rt = eng.runtime()
        before = gather_rows.launches
        if mode == "preempt":
            hs = [rt.submit(q, max_new=12) for q in prompts[:4]]
            while eng.stats.decode_steps < 3:
                rt.step()
            hs += [rt.submit(q, max_new=6, slo="interactive")
                   for q in prompts[4:]]
        else:
            hs = [rt.submit(q, max_new=10) for q in prompts]
        rt.drain()
        st = eng.stats
        seen.append(([h.tokens for h in hs],
                     (st.preemptions, st.resumes, st.idle_spills,
                      st.kv_spill_bytes, st.kv_restore_bytes, st.d2h_pulls),
                     dataclasses.asdict(eng.kv_pool.stats()) if over
                     else None,
                     dataclasses.asdict(eng.store.stats()),
                     (eng.store.cache.evictions, eng.store.cache.total_hits),
                     _links(eng.clock),
                     (gather_rows.launches - before, st.decode_steps)))
    cpu, card, plain = seen
    assert card[:6] == cpu[:6]
    assert card[0] == plain[0]
    assert card[1][1] > 0 and card[1][3] == card[1][4] > 0
    assert cpu[6][0] == 0 and card[6][0] == card[6][1]


@pytest.mark.cuda
@pytest.mark.parametrize("pool,nodes", [("CXL+SSD", None), ("CXL", 2)])
def test_tiers_engine_card_equals_cpu(pool, nodes):
    """Reduced engram-27b (f32) at the emulated operating point over a
    CXL+SSD chain and over a 2-node fabric that loses node 1 after decode
    wave 2: the card emits the CPU's streams, equal to the plain CXL
    engine's, with the same StoreStats, fabric stats and clock."""
    import dataclasses

    from repro_torch.configs import StoreConfig, engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Engine
    dev = _card()
    cfg = engram_27b.reduced()
    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=64, warm_rows=512,
                                      aging_half_life_s=2e-4)))
    params = init_params(cfg, seed=0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params)
    rng = np.random.RandomState(10)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
               for n in (5, 12, 8, 3)]
    kw = dict(max_batch=2, max_len=64, prompt_bucket=8, emulate_step_s=5e-5,
              fabric_nodes=nodes)
    seen = []
    for device, p, tiered in (("cpu", params, True),
                              (dev, params_dev, True),
                              (dev, params_dev, False)):
        eng = Engine(ccfg, params=p, pool=pool if tiered else "CXL",
                     device=device, **(kw if tiered else dict(
                         kw, fabric_nodes=None)))
        rt = eng.runtime()
        hs = [rt.submit(q, max_new=8) for q in prompts]
        while eng.busy:
            if eng.fabric is not None and eng.stats.decode_steps == 2 \
                    and eng.fabric.nodes[1].alive:
                eng.fabric.kill(1)
            rt.step()
        seen.append(([h.tokens for h in hs],
                     dataclasses.asdict(eng.store.stats()),
                     eng.fabric.stats() if eng.fabric is not None else None,
                     _links(eng.clock)))
    cpu, card, plain = seen
    assert card == cpu
    assert card[0] == plain[0]
    if nodes:
        assert card[2]["rescues"]
    else:
        assert card[1]["cold_misses"] > 0
