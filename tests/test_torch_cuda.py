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


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_router_card_equals_cpu(shared):
    """``serve()`` of a two-replica Router on reduced engram-27b (f32) at
    the emulated operating point, ``least_loaded`` with re-dispatch, a
    TinyLFU hot-row cache shared by both replicas or private to each,
    poisson arrivals of 2 to 5 new tokens: the card emits the CPU's
    streams and rids with the same RouterStats, cache stats, per-replica
    StoreStats and clock, and one f32 head serves both replicas."""
    import dataclasses

    from repro_torch.configs import StoreConfig, engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Workload, serve
    dev = _card()
    cfg = engram_27b.reduced()
    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=2048, admission="tinylfu")))
    params = init_params(cfg, seed=0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params)
    wl = Workload(requests=8, max_new=2, max_new_jitter=3, prompt_pool=3,
                  arrival="poisson", qps=1e5, seed=1)
    lens = [spec.max_new for spec in wl.build(cfg.vocab_size)]
    host_timed = ("wall_s", "ttft_s_sum")
    seen = []
    for device, p in (("cpu", params), (dev, params_dev)):
        res = serve(ccfg, wl, pool="CXL", replicas=2, policy="least_loaded",
                    shared_cache=shared, params=p, device=device,
                    max_batch=2, max_len=64, prompt_bucket=8,
                    emulate_step_s=5e-5)
        router, hs = res.router, res.handles
        heads = {id(rt.engine.params["head"]["w32"])
                 for rt in router.replicas}
        assert len(heads) == 1
        rs = router.stats()
        seen.append(([h.tokens for h in hs], [h.rid for h in hs],
                     {n: {k: v for k, v in dataclasses.asdict(st).items()
                          if k not in host_timed}
                      for n, st in rs.per_replica.items()},
                     dataclasses.asdict(rs.cache) if shared else None,
                     {n: dataclasses.asdict(st)
                      for n, st in router.store_stats().items()},
                     rs.migrations, _links(router.clock)))
    cpu, card = seen
    assert card == cpu
    assert card[5] > 0
    assert [len(t) for t in card[0]] == lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_host_table_bit_equal(dtype):
    """K1 on a table in a registered (pinned, mapped) host buffer reads it
    in place: bit-equal to its plain version on the CPU and to K1 on an HBM
    copy, one launch per call, the rows on the card; a slice of the buffer
    (an interior address) too."""
    from repro_torch.kernels.engram_gather import host_empty, is_mapped
    dev = _card()
    table = host_empty((4096, 160), TORCH_DTYPES[dtype])
    table.copy_(torch.randn(4096, 160).to(TORCH_DTYPES[dtype]))
    assert is_mapped(table) and is_mapped(table[7:])
    gid = torch.randint(0, 4000, (2, 333), device=dev)
    before = gather_rows.launches
    got = gather_rows_multi([table, table[7:]], gid)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1 and got.device == gid.device
    want = gather_rows_multi_ref([table, table[7:]], gid.cpu())
    assert torch.equal(got.cpu(), want)
    hbm = table.to(dev)
    assert torch.equal(got, gather_rows_multi([hbm, hbm[7:]], gid))
    idx = torch.randint(0, 256, (8, 1, 16), device=dev)
    tables = table.view(16, 256, 160)
    assert torch.equal(engram_gather(tables, idx).cpu(),
                       engram_gather_ref(tables, idx.cpu()))


@pytest.mark.cuda
def test_gather_rows_pageable_table_raises():
    """A pageable CPU table with row ids on the card raises: no plain
    version, no copy, no launch."""
    dev = _card()
    table = torch.randn(100, 160)
    before = gather_rows.launches
    with pytest.raises(ValueError, match="pageable"):
        gather_rows(table, torch.zeros(4, dtype=torch.int64, device=dev))
    assert gather_rows.launches == before


@pytest.mark.cuda
def test_init_params_pinned_host_bytes_equal_plain_draw():
    """table_memory="pinned_host" draws the tables on the card chunk by
    chunk into mapped host buffers: every leaf's bytes equal a plain draw's
    (the tables with a chunk smaller than a table, so several chunks and a
    ragged last one), and the buffers are reused in place when given."""
    import dataclasses

    from repro_torch.configs import engram_27b
    from repro_torch.kernels.engram_gather import is_mapped
    from repro_torch.models import params as params_mod
    from repro_torch.models.params import init_params, tree_leaves
    dev = _card()
    cfg = engram_27b.reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    chunk = params_mod._INIT_CHUNK
    params_mod._INIT_CHUNK = 100_003
    try:
        plain = init_params(cfg, 5, dev)
        host = init_params(cfg, 5, dev, table_memory="pinned_host")
        tables = [layer["tables"] for layer in host["engram"]["layers"]]
        again = init_params(cfg, 5, dev, table_memory="pinned_host",
                            host_tables=tables)
    finally:
        params_mod._INIT_CHUNK = chunk
    assert all(is_mapped(t) for t in tables)
    assert all(layer["tables"] is t
               for layer, t in zip(again["engram"]["layers"], tables))
    for a, b in zip(tree_leaves(plain), tree_leaves(host)):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_fetch_layers_host_tables_rows_on_card():
    """fetch_layers uploads the ids to the fetchers' compute device: with
    host tables the rows come from K1 on the card, equal to an HBM fetch."""
    from repro_torch.configs import engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tables_to_host
    from repro_torch.pool.store import TableFetcher, fetch_layers
    dev = _card()
    cfg = engram_27b.reduced()
    params = init_params(cfg, seed=0, device=dev)
    hbm = [layer["tables"] for layer in params["engram"]["layers"]]
    tables_to_host(params)
    host = [layer["tables"] for layer in params["engram"]["layers"]]
    assert all(t.device.type == "cpu" for t in host)
    rng = np.random.RandomState(0)
    keys = rng.randint(0, cfg.engram.n_tables * cfg.engram.table_vocab,
                       size=(len(host), 40))
    f_host = [TableFetcher(cfg.engram, t, device=dev) for t in host]
    f_hbm = [TableFetcher(cfg.engram, t) for t in hbm]
    gids = [f.gid_for(k) for f, k in zip(f_host, keys)]
    before = gather_rows.launches
    got = fetch_layers(f_host, gids)
    assert got.device.type == "cuda" and gather_rows.launches == before + 1
    assert torch.equal(got, fetch_layers(f_hbm, gids))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pool", "pool_none", "chunked", "spec"])
def test_engine_host_tables_card_equals_hbm(mode):
    """engram-27b reduced in bf16 with pooled_host and host tables against
    the same weights with HBM tables, on every retrieval path: pool-mode
    decode waves, pool=None decode, chunk waves, and the pool=None block
    path of speculative verify waves. Identical streams, and K1 on every
    retrieval (a CPU table with ids on the card cannot take the plain
    version: K1 or raise). A placement that disagrees with the strategy
    raises."""
    import dataclasses

    from repro_torch.configs import SpecConfig, engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tables_to_host, tree_map
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import Engine
    dev = _card()
    cfg = dataclasses.replace(engram_27b.reduced(), dtype="bfloat16")
    n_eng = len(cfg.engram_layers())
    host_flags = RunFlags(engram_strategy="pooled_host")
    params = init_params(cfg, seed=0, device=dev)
    kw = dict(max_batch=4, max_len=64, prompt_bucket=8, device=dev,
              pool=None if mode in ("pool_none", "spec") else "CXL")
    if mode == "chunked":
        kw.update(prefill_chunk=4)
    if mode == "spec":
        kw.update(spec=SpecConfig(proposer="ngram", max_draft=2))
    prompts = [[5, 17, 42], [7, 8, 9, 10], [3, 1, 4, 1, 5, 9], [11, 12]]

    def serve(eng):
        rt = eng.runtime()
        hs = [rt.submit(p, max_new=6) for p in prompts]
        while eng.busy:
            rt.step()
        return [h.tokens for h in hs]

    want = serve(Engine(cfg, params=params, **kw))
    with pytest.raises(ValueError, match="tables live in"):
        Engine(cfg, params=params, flags=host_flags, **kw)
    host = tables_to_host(tree_map(lambda t: t, params))
    with pytest.raises(ValueError, match="tables live in"):
        Engine(cfg, params=host, **kw)
    eng = Engine(cfg, params=host, flags=host_flags, **kw)
    before = gather_rows.launches
    assert serve(eng) == want
    launches, st = gather_rows.launches - before, eng.stats
    if mode == "pool":
        assert launches == st.decode_steps + n_eng * st.prefill_waves
    elif mode == "pool_none":
        assert launches == n_eng * (st.decode_steps + st.prefill_waves)
    else:
        assert launches > st.decode_steps


@pytest.mark.cuda
@pytest.mark.parametrize("d,T", [(4608, 8), (4608, 256), (1152, 8),
                                 (1152, 256), (1152, 2112)])
def test_gated_fuse_kernel_gemma_widths(d, T):
    """K2 at gemma2-27b's width (4608: decode waves and admission groups)
    and gemma3-1b's (1152, also a 2100-token prompt's 2112 rows), with
    ENGRAM_27B's F = 2560, bf16: within one bf16 ulp of the plain version
    and bit-identical across two calls."""
    dev = _card()
    F = 2560
    rng = np.random.RandomState(d + T)
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
def test_tied_tree_f32_head_made_once():
    """A tied tree (reduced gemma3-1b, its embedding in bf16) on the card:
    the router makes one f32 (d, V) head from the embedding, every
    replica's engine holds that tensor, an engine over the prepared tree
    keeps it, and the replicas serve the CPU's streams."""
    from repro_torch.configs import gemma3_1b
    from repro_torch.models.layers import with_f32_head
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Engine, Router
    dev = _card()
    cfg = gemma3_1b.reduced()
    params = init_params(cfg, seed=0, device="cpu")
    params["embed"]["w"] = params["embed"]["w"].bfloat16()
    kw = dict(replicas=2, pool="CXL", max_batch=2, max_len=64,
              prompt_bucket=8)
    prompts = [[5, 17, 42] * 6, [7, 8, 9, 10] * 5]
    seen = []
    for device, p in (("cpu", params),
                      (dev, tree_map(lambda t: t.to(dev), params))):
        router = Router(cfg, params=p, device=device, **kw)
        w32 = [rt.engine.params["embed"]["w32"] for rt in router.replicas]
        assert w32[0] is w32[1] and w32[0].dtype == torch.float32
        assert tuple(w32[0].shape) == (cfg.d_model, cfg.vocab_size)
        assert "w32" not in p["embed"]
        prepared = with_f32_head(p)
        eng = Engine(cfg, params=prepared, device=device, max_batch=2,
                     max_len=64, prompt_bucket=8)
        assert eng.params["embed"]["w32"] is prepared["embed"]["w32"]
        hs = [router.submit(q, max_new=6) for q in prompts]
        router.drain()
        seen.append([h.tokens for h in hs])
    assert seen[0] == seen[1]


@pytest.mark.cuda
@pytest.mark.parametrize("window_slice", [False, True])
@pytest.mark.parametrize("name", ["gemma2-27b", "gemma3-1b"])
def test_gemma_engine_card_equals_cpu(name, window_slice):
    """Reduced gemma2-27b and gemma3-1b (f32, a 16-token window), pool CXL,
    prompts of 18 to 30 tokens and 12 new ones, ``decode_window_slice``
    off and on: the card (kernels) emits the CPU's streams, with K1 once
    per decode wave."""
    import importlib

    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import Engine
    dev = _card()
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")
    cfg = mod.reduced()
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(5)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, size=n)]
               for n in (18, 23, 30)]
    seen = []
    for device, p in (("cpu", params),
                      (dev, tree_map(lambda t: t.to(dev), params))):
        eng = Engine(cfg, params=p, device=device, pool="CXL", max_batch=2,
                     max_len=64, prompt_bucket=8,
                     flags=RunFlags(decode_window_slice=window_slice))
        before = gather_rows.launches
        rids = [eng.submit(q, max_new=12) for q in prompts]
        eng.run()
        seen.append([eng.done[r].out for r in rids])
    assert gather_rows.launches - before == eng.stats.decode_steps
    assert seen[0] == seen[1]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 256])
def test_grouped_mm_matches_plain_loop_without_sync(T):
    """The MoE path's grouped GEMM (``torch._grouped_mm``) over T x 6 bf16
    rows in 64 expert groups (at T = 8 most are empty), against its plain
    per-expert loop within one bf16 ulp; the offsets and the call, and a
    whole bf16 MoE layer (route, sort, both GEMMs, combine), make no
    sync."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.models import moe
    from repro_torch.models.params import tree_init
    dev = _card()
    E, k, d, n = 64, 6, 512, 384
    gen = torch.Generator(device=dev).manual_seed(T)
    se, _ = torch.sort(torch.randint(0, E, (T * k,), device=dev,
                                     generator=gen))
    rows = torch.randn(T * k, d, device=dev, generator=gen).bfloat16()
    w = (torch.randn(E, d, n, device=dev, generator=gen)
         / d ** 0.5).bfloat16()
    cfg = ModelConfig(name="moe-card", family="moe", n_layers=1,
                      d_model=d, vocab_size=97, n_heads=4, n_kv_heads=4,
                      head_dim=128, d_ff=1024, dtype="bfloat16",
                      moe=MoEConfig(n_experts=E, top_k=k, n_shared=2,
                                    d_ff_expert=n // 2),
                      ffn_types=("moe",))
    params = tree_init(moe.moe_defs(cfg, "bfloat16"), 0, dev)
    x = torch.randn(1, T, d, device=dev, generator=gen).bfloat16()
    torch.cuda.synchronize()
    before = moe.grouped_mm.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        offs = torch.searchsorted(se, torch.arange(1, E + 1, device=dev),
                                  out_int32=True)
        got = moe.grouped_mm(rows, w, offs)
        out, _ = moe.moe_ffn(cfg, params, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert moe.grouped_mm.launches == before + 3
    torch.testing.assert_close(got, moe.grouped_mm_ref(rows, w, offs),
                               **BF16_TOL)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jamba_1_5_large_398b", "xlstm_125m"])
def test_recurrent_engine_card_equals_cpu(name):
    """The reduced recurrent configs (f32; Mamba, mLSTM, sLSTM), pool CXL
    at the emulated operating point: chunked admission with a prefix
    cache, one prompt prefilled while another decodes (its recurrent
    state gated under the decode waves), then monolithic admission and
    speculation with an always-wrong proposer (rolled back every wave):
    the card's streams, prefix hits, StoreStats and PrefixCacheStats are
    the CPU's, and the speculative streams the monolithic ones."""
    import dataclasses
    import importlib

    from repro_torch.configs import SpecConfig
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.pool.cache import PrefixKVCache
    from repro_torch.serving import Engine
    from repro_torch.spec import ConstantProposer
    dev = _card()
    cfg = importlib.import_module(f"repro_torch.configs.{name}").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(7)
    head = [int(t) for t in rng.randint(1, cfg.vocab_size, size=16)]
    long, *rest = [head + [int(t) for t in rng.randint(1, cfg.vocab_size,
                                                         size=n)]
                   for n in (12, 3, 7)]
    short = [int(t) for t in rng.randint(1, cfg.vocab_size, size=5)]
    kw = dict(pool="CXL", max_batch=2, max_len=64, prompt_bucket=8,
              emulate_step_s=5e-5)

    def serve(eng, prompts):
        rids = [eng.submit(q, max_new=6) for q in prompts]
        eng.run()
        return [eng.done[r].out for r in rids]

    seen = []
    for device, p in (("cpu", params),
                      (dev, tree_map(lambda t: t.to(dev), params))):
        eng = Engine(cfg, params=p, prefill_chunk=8,
                     prefix_cache=PrefixKVCache(64 << 20, 8), device=device,
                     **kw)
        rt = eng.runtime()
        hs = [rt.submit(short, 6)]
        rt.step()
        hs.append(rt.submit(long, 6))
        rt.drain()
        hs += [rt.submit(q, 6) for q in rest]
        rt.drain()
        mono = serve(Engine(cfg, params=p, device=device, **kw),
                     [short, long])
        spec = serve(Engine(cfg, params=p, device=device, spec=SpecConfig(),
                            proposer=ConstantProposer(-1), **kw),
                     [short, long])
        seen.append(([h.tokens for h in hs], mono, spec,
                     eng.stats.prefix_hit_blocks,
                     dataclasses.asdict(eng.store.stats()),
                     dataclasses.asdict(eng.prefix_cache.stats())))
    assert seen[0] == seen[1]
    assert seen[1][1] == seen[1][2] and seen[1][3] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 7, 128, 513), (8, 40, 512, 256)])
def test_f32_bmm_route_on_the_card(shape):
    """``attention.f32_bmm`` on bf16 operands: ``aten::bmm.dtype`` on the
    card (f32 accumulation and output) against the CPU route (upcast, f32
    bmm) within f32 summation order; a transposed operand takes the same
    route, and a bf16 ``bmm`` would round the output to bf16."""
    from repro_torch.models.attention import f32_bmm
    dev = _card()
    n, m, k, p = shape
    a = torch.randn(n, m, k).bfloat16()
    b = torch.randn(n, p, k).bfloat16().transpose(1, 2)
    want = f32_bmm(a, b)
    got = f32_bmm(a.to(dev), b.to(dev))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
    rounded = torch.bmm(a.to(dev), b.to(dev)).float().cpu()
    assert (rounded - want).abs().max() > (got.cpu() - want).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hubert_xlarge", "internvl2_1b"])
def test_frontends_card_equal_cpu(name):
    """Reduced hubert-xlarge's encoder logits (dense and chunked past 3
    pad keys) and reduced internvl2-1b's prefill with its patch tokens
    and with ``attn_bf16_scores``, card against CPU (f32)."""
    import importlib
    from repro_torch.models.model import (build_encoder_step,
                                          build_prefill_step, init_params)
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer import RunFlags
    dev = _card()
    cfg = importlib.import_module(f"repro_torch.configs.{name}").reduced()
    params = init_params(cfg, 0, "cpu")
    on_card = tree_map(lambda t: t.to(dev), params)
    gen = torch.Generator().manual_seed(3)
    if cfg.is_encoder:
        batch = {"frames": torch.randn(2, 21, cfg.frontend_dim,
                                       generator=gen)}
        steps = [build_encoder_step(cfg, RunFlags(**kw)) for kw in
                 ({}, dict(chunk_threshold=8, q_chunk=8, kv_chunk=8))]
    else:
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (2, 16),
                                         generator=gen),
                 "patches": torch.randn(2, cfg.n_patch_tokens,
                                        cfg.frontend_dim, generator=gen)}
        steps = [lambda p, b, _s=build_prefill_step(cfg, RunFlags(**kw)):
                 _s(p, b)[0] for kw in ({}, dict(attn_bf16_scores=True))]
    for step in steps:
        want = step(params, batch)
        got = step(on_card, tree_map(lambda t: t.to(dev), batch))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
