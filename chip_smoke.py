#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each of which must pass (any failure exits nonzero before the
result lines are printed):

  1. device   the card's name and power limit (nvidia-smi); TF32 off.
  2. build    both CUDA kernels from ``src/repro_torch/csrc`` into
              ``build/kernels/`` (one nvcc per source, in parallel).
  3. K1       engram_gather against its plain version, bit-equal, at the
              engram-27b table shape (16 x 2,265,088 x 160 bf16): one
              table, the decode wave's one launch over both Engram
              layers' tables (2 x 128 rows) and the verify wave's (2 x
              512 rows); and on small tables whose rows are not 16-byte
              aligned; timed beside index_select.
  4. K2       gated_fuse against its plain version at d = 5120, F = 2560
              in bf16 (T = 8, 32, 64, 96, 128, 256 and 2112: decode,
              prefill groups of 1 to 4 and of 8 x 32 tokens, a
              2100-token prompt; every timed call with its own
              cold weights; the split plan printed) and on small ragged
              shapes in bf16 and float32; timed.
  5. agree    the reduced engram-27b config served on the card (kernels)
              and on the CPU (plain versions) in float32: identical token
              streams and matching prefill logits.
  6. agree    the same, chunked (``prefill_chunk=8``, a PrefixKVCache,
              later prompts restoring a shared head), and a 2100-token
              prompt through monolithic admission (chunked attention in
              every layer), at the emulated operating point: identical
              streams, StoreStats and PrefixCacheStats; and speculative
              decoding (n-gram proposer, pipelined proposals) on card and
              CPU: identical streams, equal to the non-speculative
              engine's, with equal StoreStats, counters and clock; and
              overload (a TinyLFU hot-row cache, ``OverloadPolicy()``,
              ``PoolArbiter(kv_cache_share=0.25)``, 4 batch requests and
              2 interactive ones that preempt) and the storage tiers (a
              ``CXL+SSD`` chain, a 2-node fabric losing node 1) on card
              and CPU: identical streams (equal to the runs without the
              policy or the tiers), counters, KVPoolStats, StoreStats,
              fabric stats and clock.
  7. serve    engram-27b at full width and full depth (36 layers, 22.9 B
              parameters, seeded random bf16 weights drawn on the card,
              shared by phases 7 to 10) behind ``Engine(pool="CXL",
              max_batch=8, max_len=512)``: after a warm-up at the same
              shapes, 8 requests with 16 new tokens each, twice: kernel
              launch counts (K1 once per decode wave), one device->host
              read per steady decode wave, no other sync; then a profile.
  8. long     one 2100-token prompt, 8 new tokens, monolithic admission,
              ``max_len=4096``: TTFT and peak memory.
  9. chunked  ``prefill_chunk=16``, a PrefixKVCache and a TinyLFU hot-row
              cache: 8 prompts of 40 to 64 tokens sharing a 32-token
              head, 8 new tokens each, run twice; prefix and hot-row hits
              on the second run, launch and read budgets per step.
 10. spec     speculative decoding (k = 3 drafts, m = 4 unrolled verify
              steps) on phase 7's engine shapes and prompts: (a) a
              ScriptedProposer over phase 7's streams with pipelined
              proposals, 16 new tokens, after a warm-up, then a profile;
              (b) the n-gram proposer and (c) a one-layer draft model, 8
              new tokens each. Each run must emit phase 7's tokens
              exactly, with K1 once per verify wave, K2 twice per unrolled
              step and prefill group, one read per fully pipelined wave
              and two per other wave (plus one per admission group, and
              in (c) one per draft proposal), and no other sync.
 11. overload ``OverloadPolicy()``, ``PoolArbiter(kv_cache_share=0.25)``
              and phase 9's hot-row cache at the emulated operating
              point: (a) phase 7's prompts as batch requests, 16 new
              tokens, and after decode wave 4 two interactive requests
              that preempt two of them (their KV parked on the host and
              restored later); (b) idle spill (``idle_spill_tokens=4``),
              12 requests into 8 slots. Phase 7's tokens exactly, K1 once
              per decode wave, one read per preemption on top of the
              reference's budget, no other sync; each spill's and
              restore's time (CUDA events) beside its CXL booking.
 12. tiers    phase 7's prompts, 8 new tokens, emulated point: (a) a
              ``CXL+SSD`` chain; (b) a 4-node fabric, node 1 degraded 4x
              after decode wave 2, node 2 killed after wave 4. Phase 7's
              tokens, K1 once per decode wave, one read per steady wave;
              the chain's front + warm + cold rows add up to each wave's
              segments; the fabric's rescue window.
 13. fleet    two replicas over phase 7's parameter set and one f32 head:
              (a) a ``Router`` with one shared TinyLFU hot-row cache of
              2**20 rows, then private caches, each prompt served on one
              replica and then on the other; (b) ``serve()`` of a poisson
              ``Workload`` over ``least_loaded`` replicas at the emulated
              point, each replica's stall replayed with the fleet's
              traces; (c) Table 2, ``serve()`` on DRAM, CXL and RDMA at the
              emulated point. Phase 7's tokens, K1 once per decode wave of
              every replica, one read per busy replica per steady wave,
              the shared cache out-hitting the private ones; the drive's
              host-clock time beside the merged (parallel-hardware model)
              tokens/s; (d) the top-2 logit margin where a prompt admitted
              in a group of 4 rows leaves phase 7's stream, with K2 and
              with its plain version in its place. Phase 6 also holds a
              two-replica fleet card = CPU.

The line before the last is a JSON object listing both kernels (launches
summed over phases 7 to 13); the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)   # one bf16 ulp (8-bit mantissa)
F32_TOL = dict(rtol=1e-5, atol=1e-5)         # f32 sums in another order


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, args_list, warmup: int = 3) -> float:
    """Mean ms per call over ``args_list`` between CUDA events, after
    warm-up: host launch cost included (it dominates tiny kernels).
    Distinct argument sets per call keep gathered rows cold in L2."""
    import torch
    for a in args_list[:warmup]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in args_list:
        fn(*a)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(args_list)


def device_ms(fn, args_list, warmup: int = 3) -> float:
    """Mean device time per call: every kernel, copy and fill the profiler
    (CUPTI) records over ``args_list``, summed, over the call count. Raises
    if the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for a in args_list[:warmup]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args_list:
            fn(*a)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    check(us > 0, "the profiler recorded no device time")
    return us / 1e3 / len(args_list)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------

def check_k1(cfg, dev) -> dict:
    import torch
    from repro_torch.core.engram import padded_vocab
    from repro_torch.kernels.engram_gather import (engram_gather,
                                                   engram_gather_ref,
                                                   gather_rows,
                                                   gather_rows_multi,
                                                   gather_rows_multi_ref,
                                                   gather_rows_ref)
    from repro_torch.models.params import pd, tree_init
    e = cfg.engram
    L = len(cfg.engram_layers())
    T, V, hd = e.n_tables, padded_vocab(e), e.head_dim
    tables = [tree_init(pd(T, V, hd, dtype="bfloat16", scale=1.0), 1 + j,
                        dev) for j in range(L)]
    gen = torch.Generator(device=dev).manual_seed(1)
    flats = [t.view(T * V, hd) for t in tables]
    flat = flats[0]
    row_bytes = hd * tables[0].element_size()
    index_select = lambda t, g: torch.index_select(t, 0, g)  # noqa: E731
    result = {}
    def cold(shape):
        """40 calls' worth of fresh random row ids: on the main path a
        wave's rows are cold, so no timed call may find rows that an
        earlier call (of any of the compared functions) left in L2."""
        return [torch.randint(0, T * V, shape, generator=gen, device=dev)
                for _ in range(40)]

    for n in (16 * 8, 16 * 8 * 32):          # one layer of a decode wave;
        gids = cold((n,))                     # a 32-token prompt group of 8
        out = gather_rows(flat, gids[0])
        ref = gather_rows_ref(flat, gids[0])
        check(torch.equal(out.view(torch.int16), ref.view(torch.int16)),
              f"K1 not bit-equal at N={n}")
        err = (out.float() - ref.float()).abs().max().item()
        args = [(flat, g) for g in gids]
        ms = device_ms(gather_rows, [(flat, g) for g in cold((n,))])
        plain = device_ms(gather_rows_ref, [(flat, g) for g in cold((n,))])
        lib = device_ms(index_select, [(flat, g) for g in cold((n,))])
        b_ms, b_by = bound(2 * n * row_bytes + 8 * n, 0)
        result[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        print(f"K1 gather_rows N={n} rows x {row_bytes} B, one table: "
              f"bit-equal; device ms: kernel {ms:.5f}, plain {plain:.5f}, "
              f"index_select {lib:.5f}, byte bound {b_ms:.6f}; per call "
              f"with launch: kernel {call_ms(gather_rows, args):.5f}, plain "
              f"{call_ms(gather_rows_ref, args):.5f}, index_select "
              f"{call_ms(index_select, args):.5f}")
    # a wave's own launch, every Engram layer's rows at once, against one
    # index_select per layer (the library route: L calls): a decode wave
    # (8 slots x 16 tables) and a speculative verify wave (8 slots x m = 4
    # block positions x 16 tables)
    per_layer = lambda ts, g: [torch.index_select(t, 0, r)  # noqa: E731
                               for t, r in zip(ts, g)]
    for key, n, what in (("wave", 16 * 8, "a decode wave"),
                         ("spec", 16 * 8 * 4, "a verify wave, B=8 m=4")):
        gids = cold((L, n))
        out = gather_rows_multi(flats, gids[0])
        ref = gather_rows_multi_ref(flats, gids[0])
        check(torch.equal(out.view(torch.int16), ref.view(torch.int16)),
              f"K1 multi-table not bit-equal at {L} x {n}")
        args = [(flats, g) for g in gids]
        ms = device_ms(gather_rows_multi, [(flats, g) for g in cold((L, n))])
        plain = device_ms(gather_rows_multi_ref,
                          [(flats, g) for g in cold((L, n))])
        lib = device_ms(per_layer, [(flats, g) for g in cold((L, n))])
        b_ms, b_by = bound(L * (2 * n * row_bytes + 8 * n), 0)
        result[key] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                           library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        print(f"K1 gather_rows_multi {L} tables x {n} rows ({what}, one "
              f"launch): bit-equal; device ms: kernel {ms:.5f}, plain "
              f"{plain:.5f}, {L} index_selects {lib:.5f}, byte bound "
              f"{b_ms:.6f}; per call with launch: kernel "
              f"{call_ms(gather_rows_multi, args):.5f}, {L} index_selects "
              f"{call_ms(per_layer, args):.5f}")
    idx = torch.randint(0, V, (8, 1, T), generator=gen, device=dev)
    check(torch.equal(engram_gather(tables[0], idx).view(torch.int16),
                      engram_gather_ref(tables[0], idx).view(torch.int16)),
          "K1 engram_gather (T sub-tables) not bit-equal")
    del tables, flats, flat
    # rows whose width, stride or base are not 16-byte aligned
    small = [torch.randn(1000, 7, device=dev).to(torch.bfloat16),
             torch.randn(1000, 5, device=dev),
             torch.randn(1000, 160, device=dev).to(torch.bfloat16)[:, 1:],
             torch.randn(1000, 3, device=dev, dtype=torch.float64)]
    for tab in small:
        g = torch.randint(0, tab.shape[0], (77,), generator=gen, device=dev)
        check(torch.equal(gather_rows(tab, g), gather_rows_ref(tab, g)),
              f"K1 not bit-equal on a {tuple(tab.shape)} {tab.dtype} table "
              f"with row stride {tab.stride(0)}")
    # two tables of different row strides, one of them not 16-byte aligned
    pair = [torch.randn(900, 160, device=dev).to(torch.bfloat16),
            torch.randn(700, 168, device=dev).to(torch.bfloat16)[:, 3:163]]
    g = torch.stack([torch.randint(0, t.shape[0], (77,), generator=gen,
                                   device=dev) for t in pair])
    check(torch.equal(gather_rows_multi(pair, g),
                      gather_rows_multi_ref(pair, g)),
          "K1 multi-table not bit-equal over unaligned row strides")
    torch.cuda.synchronize()
    print("K1 unaligned rows (bf16 hd=7, f32 hd=5, bf16 stride-offset "
          "view, f64 hd=3; two tables of row strides 320 and 336 B, one "
          "offset by 6 B): bit-equal")
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 4: K2
# ---------------------------------------------------------------------------

def check_k2(cfg, dev) -> dict:
    import torch
    from repro_torch.kernels.gated_fuse import (engram_gated_fuse,
                                                gated_fuse_ref)
    from repro_torch.kernels.gated_fuse.ops import plan_split
    d = cfg.d_model
    F = len(cfg.engram.orders) * cfg.engram.emb_dim
    gen = torch.Generator(device=dev).manual_seed(2)

    def operands(n_t, d, F, dtype):
        mk = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa
        return (mk(n_t, d).to(dtype), mk(n_t, F).to(dtype),
                (mk(d, d) / math.sqrt(d)).to(dtype),
                (mk(F, d) / math.sqrt(F)).to(dtype))

    result = {}
    # decode batch; prefill groups of 1 to 4 x 32 tokens (the fleet's
    # admission groups); 8 x 32-token prefill group; a 2100-token prompt
    for n_t in (8, 32, 64, 96, 128, 256, 2112):
        # each timed call has its own weights (78.6 MB, beyond the 50 MB
        # L2): on the main path K2's weights are never warm
        sets = [operands(n_t, d, F, torch.bfloat16) for _ in range(10)]
        out = engram_gated_fuse(*sets[0])
        ref = gated_fuse_ref(*sets[0])
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
        check(torch.equal(out, engram_gated_fuse(*sets[0])),
              f"K2 not bit-identical across two calls at T={n_t}")
        err = (out.float() - ref.float()).abs().max().item()
        ms = device_ms(engram_gated_fuse, sets)
        plain = device_ms(gated_fuse_ref, sets)
        nbytes = 2 * (2 * n_t * d + n_t * F + d * d + F * d)
        flops = 2 * n_t * d * (d + F)
        b_ms, b_by = bound(nbytes, flops)
        plan = plan_split(n_t, d, F)
        result[n_t] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           library_ms=None, bound_ms=b_ms, bound_by=b_by)
        print(f"K2 gated_fuse T={n_t} d={d} F={F} bf16: token tile "
              f"{plan.bn}, split {plan.s_g} + {plan.s_p} parts (slabs per "
              f"part {plan.q_g}, {plan.q_p}), grid {plan.grid} = "
              f"{plan.blocks} blocks; max|err| {err:.3e} within rtol=2^-7 "
              f"atol=1e-3, bit-identical across calls; device ms, cold "
              f"weights: kernel {ms:.5f}, plain {plain:.5f}, bound "
              f"{b_ms:.6f} ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP, {100 * b_ms / ms:.1f} % of bound); "
              f"per call with launch: kernel "
              f"{call_ms(engram_gated_fuse, sets):.5f}")
        del sets, out, ref
        torch.cuda.empty_cache()
    for n_t, dd, ff, dtype, tol in ((5, 100, 36, torch.bfloat16, BF16_TOL),
                                    (13, 512, 264, torch.bfloat16, BF16_TOL),
                                    (37, 98, 30, torch.float32, F32_TOL),
                                    (40, 128, 64, torch.float32, F32_TOL)):
        ops = operands(n_t, dd, ff, dtype)
        torch.testing.assert_close(engram_gated_fuse(*ops).float(),
                                   gated_fuse_ref(*ops).float(), **tol)
    print("K2 ragged shapes (bf16 5x100x36 element loads, bf16 13x512x264 "
          "cp.async, f32 37x98x30 scalar loads, f32 40x128x64 vector "
          "loads): within tolerance")
    return result


# ---------------------------------------------------------------------------
# phase 5: the card agrees with the CPU on a small config
# ---------------------------------------------------------------------------

def check_agreement(dev) -> None:
    import numpy as np
    import torch
    from repro_torch.configs import engram_27b
    from repro_torch.models.model import build_prefill_step, init_params
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import Engine
    cfg = engram_27b.reduced()
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params_cpu)
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, cfg.vocab_size, size=n))
               for n in (3, 7, 12, 5)]
    streams = []
    for device, params in (("cpu", params_cpu), (dev, params_dev)):
        eng = Engine(cfg, params=params, pool="CXL", max_batch=4, max_len=64,
                     prompt_bucket=8, device=device)
        rids = [eng.submit(p, max_new=12) for p in prompts]
        eng.run()
        streams.append([eng.done[r].out for r in rids])
    check(streams[0] == streams[1],
          f"reduced engram-27b token streams differ: cpu {streams[0]} vs "
          f"card {streams[1]}")
    toks = np.zeros((2, 16), np.int64)
    toks[0, :12], toks[1, :7] = prompts[2], prompts[1]
    batch = {"tokens": torch.from_numpy(toks),
             "lengths": torch.tensor([12, 7])}
    step = build_prefill_step(cfg, RunFlags(), max_len=64)
    lc, _ = step(params_cpu, batch)
    ld, _ = step(params_dev, tree_map(lambda t: t.to(dev), batch))
    # f32 sums in another order on the card, carried through 6 layers
    torch.testing.assert_close(ld.cpu(), lc, rtol=1e-3, atol=1e-3)
    print(f"agree: reduced engram-27b (f32, pool=CXL) token streams "
          f"identical on card and CPU over {len(prompts)} requests; prefill "
          f"logits max|diff| {(ld.cpu() - lc).abs().max().item():.2e}")


def check_agreement_chunked(dev) -> None:
    """Chunked admission with a prefix cache, and a prompt past the
    2048-token chunk threshold through monolithic admission, on the card
    and on the CPU, at the emulated operating point (so StoreStats do not
    depend on host step times)."""
    import numpy as np
    from repro_torch.configs import engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.pool.cache import PrefixKVCache
    from repro_torch.serving import Engine
    cfg = engram_27b.reduced()
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params_cpu)
    rng = np.random.RandomState(1)
    head = list(rng.randint(1, cfg.vocab_size, size=16))
    prompts = [head + list(rng.randint(1, cfg.vocab_size, size=n))
               for n in (5, 9, 14)]
    long_prompt = list(rng.randint(1, cfg.vocab_size, size=2100))
    kw = dict(pool="CXL", emulate_step_s=5e-5)
    seen = []
    for device, params in (("cpu", params_cpu), (dev, params_dev)):
        eng = Engine(cfg, params=params, max_batch=2, max_len=64,
                     prompt_bucket=8, prefill_chunk=8,
                     prefix_cache=PrefixKVCache(64 << 20, 8), device=device,
                     **kw)
        streams = []
        for p in prompts:            # one at a time: later ones restore
            rid = eng.submit(p, max_new=8)
            eng.run()
            streams.append(eng.done[rid].out)
        mono = Engine(cfg, params=params, max_batch=1, max_len=2176,
                      prompt_bucket=32, device=device, **kw)
        rid = mono.submit(long_prompt, max_new=8)
        mono.run()
        streams.append(mono.done[rid].out)
        seen.append(dict(
            streams=streams, store=dataclasses.asdict(eng.store.stats()),
            prefix=dataclasses.asdict(eng.prefix_cache.stats()),
            long_store=dataclasses.asdict(mono.store.stats()),
            clock=eng.clock.stats(), hits=eng.stats.prefix_hit_blocks))
    cpu, card = seen
    for key in cpu:
        check(cpu[key] == card[key],
              f"chunked agreement: {key} differs: cpu {cpu[key]} vs card "
              f"{card[key]}")
    check(card["hits"] > 0, "no prefix-cache hit in the chunked agreement")
    print(f"agree chunked: reduced engram-27b (f32, pool=CXL, emulated "
          f"step 5e-5 s), prefill_chunk=8 with a PrefixKVCache over "
          f"{len(prompts)} prompts sharing a 16-token head "
          f"({card['hits']} blocks restored) and one 2100-token prompt "
          f"through monolithic admission: streams, StoreStats, "
          f"PrefixCacheStats and the virtual clock identical on card and "
          f"CPU")


def check_agreement_spec(dev) -> None:
    """Speculative decoding (n-gram proposer, pipelined proposals) on the
    reduced config, pool CXL at the emulated operating point, on the card
    and on the CPU: identical streams, equal to the card's non-speculative
    engine's, with equal StoreStats, speculation counters and clock."""
    import numpy as np
    from repro_torch.configs import SpecConfig, engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Engine
    cfg = engram_27b.reduced()
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params_cpu)
    rng = np.random.RandomState(2)
    phrase = list(rng.randint(1, cfg.vocab_size, size=6))
    prompts = [list(rng.randint(1, cfg.vocab_size, size=n)) + phrase
               for n in (2, 5, 9)] * 2        # repeats: the n-gram learns
    kw = dict(pool="CXL", emulate_step_s=5e-5, max_batch=3, max_len=64,
              prompt_bucket=8)
    seen = []
    for device, params, sp in (("cpu", params_cpu, SpecConfig(pipeline=True)),
                               (dev, params_dev, SpecConfig(pipeline=True)),
                               (dev, params_dev, None)):
        eng = Engine(cfg, params=params, device=device, spec=sp, **kw)
        rids = [eng.submit(p, max_new=12) for p in prompts]
        eng.run()
        st = eng.stats
        seen.append(dict(
            streams=[eng.done[r].out for r in rids],
            store=dataclasses.asdict(eng.store.stats()),
            spec=(st.spec_waves, st.proposed_tokens, st.accepted_tokens,
                  st.pipelined_hits, st.pipelined_misses, st.d2h_pulls),
            clock=eng.clock.stats()))
    cpu, card, plain = seen
    for key in cpu:
        check(cpu[key] == card[key],
              f"spec agreement: {key} differs: cpu {cpu[key]} vs card "
              f"{card[key]}")
    check(card["streams"] == plain["streams"],
          f"spec agreement: speculative streams {card['streams']} differ "
          f"from the non-speculative {plain['streams']}")
    waves, proposed, accepted, hits, misses, reads = card["spec"]
    check(accepted > 0 and hits > 0, "spec agreement: no draft accepted or "
          "no pipelined prediction survived")
    print(f"agree spec: reduced engram-27b (f32, pool=CXL, emulated step "
          f"5e-5 s), n-gram proposer with pipelined proposals over "
          f"{len(prompts)} requests: {waves} verify waves, {accepted}/"
          f"{proposed} drafts accepted, {hits} pipelined hits, {misses} "
          f"misses, {reads} reads; streams (equal to the non-speculative "
          f"engine's), StoreStats, counters and clock identical on card and "
          f"CPU")


def link_ledgers(clock) -> dict:
    """A clock's stats with per-object link names (``cache:<id>``,
    ``chainfront:<id>``) cut to their kind, so two engines compare."""
    st = clock.stats()
    links = sorted((dict(v, name=n.split(":")[0]) for n, v in
                    st["links"].items()), key=lambda d: d["name"])
    return dict(st, links=links)


def check_agreement_overload(dev) -> None:
    """Overload on the reduced config at the emulated operating point, on
    the card and on the CPU: a TinyLFU hot-row cache, ``OverloadPolicy()``
    and ``PoolArbiter(kv_cache_share=0.25)``; 4 batch requests, then 2
    interactive ones after the third decode wave. The streams (equal to a
    run without the policy), the overload counters, KVPoolStats,
    StoreStats, the cache's evictions and the clock must be identical."""
    import numpy as np
    from repro_torch.configs import StoreConfig, engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.pool import PoolArbiter
    from repro_torch.serving import Engine, OverloadPolicy
    cfg = engram_27b.reduced()
    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=2048, admission="tinylfu")))
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params_cpu)
    rng = np.random.RandomState(5)
    prompts = [list(rng.randint(1, cfg.vocab_size, size=n))
               for n in (6, 11, 4, 9, 7, 5)]
    seen = []
    for device, params, policy in (("cpu", params_cpu, True),
                                   (dev, params_dev, True),
                                   (dev, params_dev, False)):
        kw = dict(slo_policy=OverloadPolicy(),
                  arbiter=PoolArbiter(kv_cache_share=0.25)) if policy else {}
        eng = Engine(ccfg, params=params, pool="CXL", max_batch=4,
                     max_len=64, prompt_bucket=8, emulate_step_s=5e-5,
                     device=device, **kw)
        rt = eng.runtime()
        hs = [rt.submit(p, max_new=12, slo="batch") for p in prompts[:4]]
        while eng.stats.decode_steps < 3:
            rt.step()
        hs += [rt.submit(p, max_new=6, slo="interactive")
               for p in prompts[4:]]
        rt.drain()
        st = eng.stats
        seen.append(dict(
            streams=[h.tokens for h in hs],
            overload=(st.preemptions, st.resumes, st.kv_spill_bytes,
                      st.kv_restore_bytes, st.kv_spill_pages,
                      st.idle_spills, st.d2h_pulls, st.ttft_v_sum),
            kv_pool=dataclasses.asdict(eng.kv_pool.stats()) if policy
            else None,
            store=dataclasses.asdict(eng.store.stats()),
            cache=(eng.store.cache.evictions, eng.store.cache.total_hits,
                   eng.store.cache.total_misses),
            clock=link_ledgers(eng.clock)))
    cpu, card, plain = seen
    for key in cpu:
        check(cpu[key] == card[key],
              f"overload agreement: {key} differs: cpu {cpu[key]} vs card "
              f"{card[key]}")
    check(card["streams"] == plain["streams"],
          f"overload agreement: streams {card['streams']} differ from the "
          f"run without the policy {plain['streams']}")
    pre, res, spill, restore = card["overload"][:4]
    check(pre == res == 2 and spill == restore > 0,
          f"overload agreement: {pre} preemptions, {res} resumes, "
          f"{spill} B spilled, {restore} B restored")
    check(card["store"]["class_bytes"]["kv"] == spill + restore,
          "overload agreement: class_bytes['kv'] != spill + restore bytes")
    print(f"agree overload: reduced engram-27b (f32, pool=CXL, emulated "
          f"step 5e-5 s, TinyLFU cache of 2048 rows, OverloadPolicy, "
          f"PoolArbiter(kv_cache_share=0.25)), 4 batch + 2 interactive "
          f"requests into 4 slots: {pre} preemptions, {res} resumes, "
          f"{spill} B spilled and restored, cache evictions "
          f"{card['cache'][0]}; streams (equal to the run without the "
          f"policy), overload counters, KVPoolStats, StoreStats, cache and "
          f"clock identical on card and CPU")


def check_agreement_tiers(dev) -> None:
    """The storage tiers on the reduced config at the emulated operating
    point, on the card and on the CPU: a ``CXL+SSD`` chain (front 64 rows,
    warm 512 rows, sketch half-life 2e-4 s) and a two-node fabric whose
    node 1 is killed after decode wave 2. StoreStats, the fabric's stats
    and the clock must be identical, and the streams equal to the card's
    run without tiers."""
    import numpy as np
    from repro_torch.configs import StoreConfig, engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Engine
    cfg = engram_27b.reduced()
    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=64, warm_rows=512,
                                      aging_half_life_s=2e-4)))
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params_cpu)
    rng = np.random.RandomState(6)
    prompts = [list(rng.randint(1, cfg.vocab_size, size=n))
               for n in (5, 12, 8, 3)]
    kw = dict(max_batch=2, max_len=64, prompt_bucket=8, emulate_step_s=5e-5)

    def serve(device, params, c, pool, **extra):
        eng = Engine(c, params=params, pool=pool, device=device, **kw,
                     **extra)
        rt = eng.runtime()
        hs = [rt.submit(p, max_new=8) for p in prompts]
        while eng.busy:
            if eng.fabric is not None and eng.stats.decode_steps == 2 \
                    and eng.fabric.nodes[1].alive:
                eng.fabric.kill(1)
            rt.step()
        return eng, [h.tokens for h in hs]

    _, plain = serve(dev, params_dev, cfg, "CXL")
    seen = []
    for device, params in (("cpu", params_cpu), (dev, params_dev)):
        chain, s_chain = serve(device, params, ccfg, "CXL+SSD")
        fab, s_fab = serve(device, params, cfg, "CXL", fabric_nodes=2)
        seen.append(dict(
            streams=(s_chain, s_fab),
            chain=dataclasses.asdict(chain.store.stats()),
            chain_clock=link_ledgers(chain.clock),
            fabric=dataclasses.asdict(fab.store.stats()),
            fabric_stats=fab.fabric.stats(),
            fabric_clock=link_ledgers(fab.clock)))
    cpu, card = seen
    for key in cpu:
        check(cpu[key] == card[key],
              f"tiers agreement: {key} differs: cpu {cpu[key]} vs card "
              f"{card[key]}")
    check(card["streams"] == (plain, plain),
          f"tiers agreement: streams {card['streams']} differ from the "
          f"run without tiers {plain}")
    ch = card["chain"]
    check(ch["hits"] > 0 and ch["warm_hits"] > 0 and ch["cold_misses"] > 0,
          f"tiers agreement: the chain's front/warm/cold split {ch['hits']}"
          f"/{ch['warm_hits']}/{ch['cold_misses']} misses a level")
    check(bool(card["fabric_stats"]["rescues"]),
          "tiers agreement: the killed node's shards were not rescued")
    print(f"agree tiers: reduced engram-27b (f32, emulated step 5e-5 s): "
          f"CXL+SSD chain front/warm/cold {ch['hits']}/{ch['warm_hits']}/"
          f"{ch['cold_misses']} segments, {ch['promotions']} promotions, "
          f"{ch['demotions']} demotions; 2-node fabric with node 1 killed "
          f"after wave 2 ({len(card['fabric_stats']['rescues'])} shard "
          f"rescued); StoreStats, fabric stats and clock identical on card "
          f"and CPU, streams equal to the run without tiers")


def check_agreement_fleet(dev) -> None:
    """``serve()`` of a two-replica fleet on the reduced config at the
    emulated operating point, on the card and on the CPU: one TinyLFU
    ``SharedCache`` of 2048 rows, ``least_loaded`` with re-dispatch, 8
    poisson arrivals (qps 1e5) of 2 to 5 new tokens into 2 slots per
    replica. Streams, rids, RouterStats, SharedCacheStats, each replica's
    StoreStats, the link ledgers and the clock must be identical, and at
    least one request must migrate."""
    from repro_torch.configs import StoreConfig, engram_27b
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Workload, serve
    cfg = engram_27b.reduced()
    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=2048, admission="tinylfu")))
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params_cpu)
    wl = Workload(requests=8, max_new=2, max_new_jitter=3, prompt_pool=3,
                  arrival="poisson", qps=1e5, seed=1)
    lens = [s_.max_new for s_ in wl.build(cfg.vocab_size)]
    seen = []
    for device, params in (("cpu", params_cpu), (dev, params_dev)):
        res = serve(ccfg, wl, pool="CXL", replicas=2, policy="least_loaded",
                    params=params, device=device, max_batch=2, max_len=64,
                    prompt_bucket=8, emulate_step_s=5e-5)
        router, hs = res.router, res.handles
        rs = router.stats()
        host_timed = ("wall_s", "ttft_s_sum")
        seen.append(dict(
            streams=[h.tokens for h in hs], rids=[h.rid for h in hs],
            aggregate={k: v for k, v in dataclasses.asdict(
                rs.aggregate).items() if k not in host_timed},
            per_replica={n: {k: v for k, v in dataclasses.asdict(st).items()
                             if k not in host_timed}
                         for n, st in rs.per_replica.items()},
            cache=dataclasses.asdict(rs.cache),
            stores={n: dataclasses.asdict(st)
                    for n, st in router.store_stats().items()},
            migrations=rs.migrations, clock=link_ledgers(router.clock)))
    cpu, card = seen
    for key in cpu:
        check(cpu[key] == card[key],
              f"fleet agreement: {key} differs: cpu {cpu[key]} vs card "
              f"{card[key]}")
    check(card["migrations"] > 0, "fleet agreement: no request migrated")
    check(all(len(t) == n for t, n in zip(card["streams"], lens)),
          "fleet agreement: a request ended short")
    c = card["cache"]
    print(f"agree fleet: reduced engram-27b (f32, pool=CXL, emulated step "
          f"5e-5 s), 2 replicas, least_loaded with re-dispatch, one TinyLFU "
          f"SharedCache of 2048 rows, {len(lens)} poisson arrivals: "
          f"{card['migrations']} migration(s), shared cache {c['hits']} hits"
          f" / {c['misses']} misses (per replica "
          f"{ {n: v['hits'] for n, v in c['per_view'].items()} }); streams, "
          f"rids, RouterStats, SharedCacheStats, StoreStats, link ledgers "
          f"and clock identical on card and CPU")


# ---------------------------------------------------------------------------
# phases 7-10: the serving paths at full width
# ---------------------------------------------------------------------------

def draw_params(cfg, dev):
    """Full-width weights on the card, drawn once for phases 7 to 10."""
    import torch
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_leaves
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"vocab {cfg.vocab_size} engram layers {cfg.engram_layers()}: "
          f"{n_params / 1e9:.3f} B parameters drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    return params


def reset_launches() -> None:
    from repro_torch.kernels.engram_gather import gather_rows
    from repro_torch.kernels.gated_fuse import engram_gated_fuse
    gather_rows.launches = 0
    engram_gated_fuse.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.engram_gather import gather_rows
    from repro_torch.kernels.gated_fuse import engram_gated_fuse
    return {"engram_gather": gather_rows.launches,
            "gated_fuse": engram_gated_fuse.launches}


def drive(eng, rt, on_step=None) -> tuple[list, float]:
    """Step the runtime until idle under PyTorch's sync debug mode: the
    reads of each step and the run's seconds. Fails on any sync outside
    the engine's counted reads."""
    import torch
    pulls = []
    t_run = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            while eng.busy:
                before = eng.stats.d2h_pulls
                if on_step is not None:
                    on_step()
                rt.step()
                pulls.append(eng.stats.d2h_pulls - before)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    check(not syncs, f"{len(syncs)} stray syncs on the wave: {syncs[:3]}")
    return pulls, time.perf_counter() - t_run


def serve_prompts(cfg) -> list:
    """Phases 7 and 10's 8 prompts, 5 to 32 tokens (one 8 x 32 group)."""
    import numpy as np
    rng = np.random.RandomState(0)
    return [list(rng.randint(1, cfg.vocab_size, size=n))
            for n in (5, 9, 12, 16, 20, 24, 28, 32)]


def serve_full(cfg, params, dev, smi: str, reps: int = 2) -> tuple:
    """Serve 8 requests on full-width engram-27b, ``reps`` times after a
    warm-up at the same shapes; returns each kernel's launch count over
    the last run and that run's token streams."""
    import torch
    from repro_torch.serving import Engine

    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params=params, pool="CXL", max_batch=8, max_len=512,
                 prompt_bucket=32, device=dev)
    prompts = serve_prompts(cfg)
    eng.warmup(prompts)              # the measured 8 x 32 prefill group
    rt = eng.runtime()
    for rep in range(reps):
        launches, streams = serve_once(cfg, eng, rt, prompts, dev, smi, rep)
    profile_waves(eng, rt, prompts)
    return launches, streams


def serve_once(cfg, eng, rt, prompts, dev, smi: str, rep: int) -> tuple:
    """One counted run of the main path: every request to completion with
    the kernels' launch counters and the engine's stats reset just before
    it; checks the counts, the reads per wave and the outputs. Returns the
    launches and the token streams."""
    import torch
    eng.reset_stats()
    n_steps0 = len(eng._step_times)

    reset_launches()
    handles = [rt.submit(p, max_new=16) for p in prompts]
    pulls, run_s = drive(eng, rt)
    launches = read_launches()

    st = eng.stats
    check(all(h.finished and len(h.tokens) == 16 for h in handles),
          "not every request completed with 16 tokens")
    check(all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens),
          "a token outside the vocabulary")
    check(launches["engram_gather"] == st.decode_steps,
          f"K1 launches {launches['engram_gather']} != one per "
          f"{st.decode_steps} charged decode waves")
    check(launches["gated_fuse"] == 2 * (st.prefill_waves + st.decode_steps),
          f"K2 launches {launches['gated_fuse']} != 2 x "
          f"({st.prefill_waves} prefill groups + {st.decode_steps} waves)")
    check(len(pulls) == st.decode_steps and all(p == 1 for p in pulls[1:]),
          f"device->host reads per step {pulls}: want 1 per steady wave")
    logits, _ = eng._prefill_fn(eng.params, {
        "tokens": torch.tensor([prompts[0]], device=dev),
        "lengths": torch.tensor([len(prompts[0])], device=dev)})
    check(tuple(logits.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          "full-width prefill logits not finite")

    decode_s = sum(eng._step_times[n_steps0:])
    decode_tokens = st.generated_tokens - st.prefills
    print(f"serve run {rep + 1}: {len(prompts)} requests x 16 tokens, "
          f"{st.prefill_waves} prefill group(s), {st.decode_steps} decode "
          f"waves; K1 launches {launches['engram_gather']}, K2 launches "
          f"{launches['gated_fuse']}; device->host reads per step {pulls}; "
          f"no other sync")
    print(f"serve run {rep + 1} [{smi}]: decode "
          f"{decode_tokens / decode_s:.2f} tok/s ({decode_tokens} tokens in "
          f"{decode_s * 1e3:.1f} ms of decode waves), mean TTFT "
          f"{st.mean_ttft_s * 1e3:.2f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, run "
          f"{run_s:.2f} s")
    return launches, [h.tokens for h in handles]


def profile_waves(eng, rt, prompts, max_new: int = 6,
                  label: str = "profile") -> None:
    """Where a steady decode (or verify) wave's time goes, from a short
    extra run after the counted one: wall time per wave, device time per
    wave (CUPTI, all kernels summed) and the kernels that take most of it.
    The first step (admission, and in chunked mode the chunk waves) is not
    profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        rt.submit(p, max_new=max_new)
    rt.step()                        # admission + the post-admission wave
    while eng._prefill_jobs:         # chunked: the rest of the prompts
        rt.step()
    torch.cuda.synchronize()
    waves0 = eng.stats.decode_steps
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while eng.busy:
            rt.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    n = eng.stats.decode_steps - waves0
    ev = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    n_ops = sum(e.count for e in ev)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    check(n > 0, f"{label}: no wave left to profile")
    print(f"{label}: {n} steady waves under the profiler: wall "
          f"{wall_ms / n:.3f} ms/wave, device busy {dev_ms / n:.3f} ms/wave "
          f"({100 * dev_ms / wall_ms:.1f} % of wall), {n_ops / n:.0f} "
          f"device kernels/copies per wave")
    for e in top:
        print(f"{label}:   {e.self_device_time_total / 1e3 / n:9.4f} ms/wave"
              f"  {e.count / n:6.1f} calls/wave  {e.key[:90]}")


def serve_long_prompt(cfg, params, dev, smi: str) -> dict:
    """One 2100-token prompt (padded to 2112) through monolithic admission
    with ``max_len=4096``: every layer's prefill attention is chunked.
    After a warm-up with another prompt of that length, one counted run
    with 8 new tokens; returns the kernels' launches over it."""
    import numpy as np
    import torch
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving import Engine

    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params=params, pool="CXL", max_batch=8, max_len=4096,
                 prompt_bucket=32, device=dev)
    rng = np.random.RandomState(3)
    warm, prompt = (list(rng.randint(1, cfg.vocab_size, size=2100))
                    for _ in range(2))
    eng.warmup([warm])
    rt = eng.runtime()
    eng.reset_stats()
    reset_launches()
    h = rt.submit(prompt, max_new=8)
    pulls, run_s = drive(eng, rt)
    launches = read_launches()
    st = eng.stats
    check(h.finished and len(h.tokens) == 8
          and all(0 <= t < cfg.vocab_size for t in h.tokens),
          f"long prompt: {h.tokens} is not 8 tokens of the vocabulary")
    check(launches["engram_gather"] == st.decode_steps == 7,
          f"long prompt: K1 launches {launches['engram_gather']} != one "
          f"per {st.decode_steps} decode waves")
    check(launches["gated_fuse"] == 2 * (st.prefill_waves + st.decode_steps),
          f"long prompt: K2 launches {launches['gated_fuse']} != 2 x "
          f"({st.prefill_waves} prefill groups + {st.decode_steps} waves)")
    check(pulls == [3] + [1] * (st.decode_steps - 1),
          f"long prompt: device->host reads per step {pulls}")
    kv = sum(t.numel() * t.element_size()
             for t in tree_leaves(eng.state["caches"]))
    peak = torch.cuda.max_memory_allocated()
    print(f"long prompt: 2100 tokens (bucket 2112) + 8 new, monolithic "
          f"admission, chunked attention in all {cfg.n_layers} layers; K1 "
          f"launches {launches['engram_gather']}, K2 launches "
          f"{launches['gated_fuse']}; reads per step {pulls}; no other sync")
    print(f"long prompt [{smi}]: TTFT {st.mean_ttft_s * 1e3:.2f} ms, run "
          f"{run_s:.3f} s, peak memory {peak / 1e9:.2f} GB, KV cache "
          f"{kv / 1e9:.2f} GB (max_batch 8 x max_len 4096)")
    return launches


def serve_chunked(cfg, params, dev, smi: str, C: int = 16) -> dict:
    """Chunked admission with a prefix cache and a TinyLFU hot-row cache:
    8 prompts of 40 to 64 tokens sharing a 32-token head, 8 new tokens
    each, run twice. Checks, per step, the launch and read budgets, and on
    the second run prefix and hot-row hits. Returns the kernels' launches
    summed over both runs."""
    import numpy as np
    import torch
    from repro_torch.configs import StoreConfig
    from repro_torch.models.params import tree_leaves
    from repro_torch.pool.cache import PrefixKVCache
    from repro_torch.serving import Engine
    from repro_torch.serving.slots import select_slots, update_slots

    torch.cuda.reset_peak_memory_stats()
    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=1 << 20,
                                      admission="tinylfu")))
    eng = Engine(ccfg, params=params, pool="CXL", max_batch=8, max_len=512,
                 prompt_bucket=32, prefill_chunk=C,
                 prefix_cache=PrefixKVCache(1 << 30, C), device=dev)
    rt = eng.runtime()
    rng = np.random.RandomState(4)
    head = list(rng.randint(1, cfg.vocab_size, size=32))
    prompts = [head + list(rng.randint(1, cfg.vocab_size, size=n))
               for n in (8, 11, 14, 17, 21, 25, 28, 32)]
    times = {"chunk": [], "decode": []}

    def timed(name, fn):
        def wave():
            t0 = time.perf_counter()
            out = fn()
            times[name].append(time.perf_counter() - t0)
            return out
        return wave

    eng._chunk_wave = timed("chunk", eng._chunk_wave)
    eng._decode_wave = timed("decode", eng._decode_wave)
    total = {"engram_gather": 0, "gated_fuse": 0}
    for run in (1, 2):
        eng.reset_stats()
        eng.store.reset_stats()
        for v in times.values():
            v.clear()
        marks = []

        def mark():
            marks.append((eng.stats.prefill_waves, eng.stats.prefills,
                          eng.stats.decode_steps,
                          eng.prefix_cache.stats().inserts))

        reset_launches()
        handles = [rt.submit(p, max_new=8) for p in prompts]
        pulls, run_s = drive(eng, rt, on_step=mark)
        launches = read_launches()
        mark()
        st = eng.stats
        check(all(h.finished and len(h.tokens) == 8
                  and all(0 <= t < cfg.vocab_size for t in h.tokens)
                  for h in handles),
              "chunked: not every request completed with 8 tokens")
        check(launches["engram_gather"] == st.decode_steps,
              f"chunked: K1 launches {launches['engram_gather']} != one per "
              f"{st.decode_steps} decode waves")
        check(launches["gated_fuse"]
              == 2 * (st.decode_steps + C * st.prefill_waves),
              f"chunked: K2 launches {launches['gated_fuse']} != 2 x "
              f"({st.decode_steps} decode waves + {C} x {st.prefill_waves} "
              f"unrolled chunk steps)")
        # per step: one read per chunk wave, per prefix spill and per
        # decode wave, and one more on a decode wave after a job went live
        want = []
        for a, b in zip(marks, marks[1:]):
            waves, live, dec, spills = (y - x for x, y in zip(a, b))
            want.append(waves + spills + dec + int(live > 0 and dec > 0))
        check(pulls == want, f"chunked: reads per step {pulls}, want {want}")
        store = eng.store.stats()
        if run == 2:
            check(st.prefix_hit_blocks > 0, "chunked: no prefix-cache hit")
            check(store.hit_rate > 0, "chunked: no hot-row cache hit")
        chunk_ms = 1e3 * sum(times["chunk"]) / len(times["chunk"])
        dec_tokens = st.generated_tokens - st.prefills
        print(f"chunked run {run}: {len(prompts)} prompts of "
              f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens "
              f"(32-token shared head), C={C}: {st.prefill_waves} chunk "
              f"waves, {st.decode_steps} decode waves, prefix blocks "
              f"{st.prefix_hit_blocks}/{st.prefix_lookup_blocks} hit "
              f"({st.prefill_tokens_restored} tokens restored, "
              f"{st.prefill_tokens} computed), hot-row hit rate "
              f"{store.hit_rate:.4f}; K1 {launches['engram_gather']}, K2 "
              f"{launches['gated_fuse']} launches; reads per step {pulls}; "
              f"no other sync")
        print(f"chunked run {run} [{smi}]: chunk wave {chunk_ms:.1f} ms "
              f"mean wall, decode {dec_tokens / sum(times['decode']):.2f} "
              f"tok/s ({dec_tokens} tokens in "
              f"{1e3 * sum(times['decode']):.1f} ms of decode waves), mean "
              f"TTFT {st.mean_ttft_s * 1e3:.2f} ms, run {run_s:.2f} s, peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        for k in total:
            total[k] += launches[k]
    # a chunk wave's slot surgery: gather the 8 job slots' whole state and
    # scatter it back (each slot's KV at max_len 512)
    slots = list(range(8))
    ms = call_ms(lambda: update_slots(eng.state,
                                      select_slots(eng.state, slots), slots),
                 [()] * 10)
    slot_bytes = sum(t[0].numel() * t.element_size()
                     for t in tree_leaves(eng.state))
    print(f"chunked [{smi}]: select_slots + update_slots over 8 slots "
          f"({8 * slot_bytes / 1e6:.1f} MB of state gathered and written "
          f"back) {ms:.3f} ms per chunk wave")
    profile_waves(eng, rt, prompts, label="chunked profile")
    return total


def serve_spec(cfg, params, dev, smi: str, prompts, streams) -> dict:
    """Speculative decoding at full width, phase 7's engine shapes and
    prompts, three ways: (a) a ScriptedProposer over phase 7's streams,
    pipelined, 16 new tokens, after a warm-up; (b) the n-gram proposer and
    (c) a one-layer draft model, 8 new tokens each. Every run must emit
    phase 7's tokens exactly, launch K1 once per verify wave and K2 twice
    per unrolled step and prefill group, and read the device once per
    wave whose every live slot's pipelined prediction survived, twice per
    other wave, once per admission group (and in (c) once per draft
    proposal, counted by the proposer), with no other sync. Returns the
    kernels' launches summed over the three runs."""
    import torch
    from repro_torch.configs import SpecConfig
    from repro_torch.serving import Engine
    from repro_torch.spec import ScriptedProposer

    script = ScriptedProposer([p + s for p, s in zip(prompts, streams)])
    runs = (("a", SpecConfig(max_draft=3, pipeline=True), script, 16),
            ("b", SpecConfig(max_draft=3), None, 8),
            ("c", SpecConfig(max_draft=3, proposer="draft", draft_layers=1),
             None, 8))
    total = {"engram_gather": 0, "gated_fuse": 0}
    for name, sp, proposer, max_new in runs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params=params, pool="CXL", max_batch=8,
                     max_len=512, prompt_bucket=32, device=dev, spec=sp,
                     proposer=proposer)
        m = sp.max_draft + 1
        if name == "a":
            eng.warmup(prompts)
        rt = eng.runtime()
        eng.reset_stats()
        eng.store.reset_stats()
        n_steps0 = len(eng._step_times)
        waves = []                   # per verify wave: live, hits, reads

        def counted(fn=eng._spec_wave):
            live = sum(s is not None for s in eng.slots)
            hits = eng.stats.pipelined_hits
            reads = getattr(eng.proposer, "reads", 0)
            out = fn()
            if live:
                waves.append((live, eng.stats.pipelined_hits - hits,
                              getattr(eng.proposer, "reads", 0) - reads))
            return out

        eng._spec_wave = counted
        marks = []
        reset_launches()
        handles = [rt.submit(p, max_new=max_new) for p in prompts]
        pulls, run_s = drive(eng, rt, on_step=lambda: marks.append(
            eng.stats.prefill_waves))
        launches = read_launches()
        marks.append(eng.stats.prefill_waves)
        st = eng.stats
        got = [h.tokens for h in handles]
        want = [s[:max_new] for s in streams]
        check(got == want, f"spec run {name}: tokens {got} differ from the "
              f"non-speculative serve run's {want}")
        check(launches["engram_gather"] == st.spec_waves == len(waves),
              f"spec run {name}: K1 launches {launches['engram_gather']} != "
              f"one per {st.spec_waves} verify waves")
        check(launches["gated_fuse"]
              == 2 * (m * st.spec_waves + st.prefill_waves),
              f"spec run {name}: K2 launches {launches['gated_fuse']} != 2 x "
              f"({m} x {st.spec_waves} verify waves + {st.prefill_waves} "
              f"prefill groups)")
        groups = [b - a for a, b in zip(marks, marks[1:])]
        want_reads = [g + (1 if hits == live else 2)
                      for g, (live, hits, _) in zip(groups, waves)]
        check(pulls == want_reads, f"spec run {name}: reads per step "
              f"{pulls}, want {want_reads}")
        if name == "c":
            proposals = [live - hits for live, hits, _ in waves]
            check([r for _, _, r in waves] == proposals,
                  f"spec run c: draft reads per wave "
                  f"{[r for _, _, r in waves]}, want one per proposal "
                  f"{proposals}")
        peak = torch.cuda.max_memory_allocated()
        dec_tokens = st.generated_tokens - st.prefills
        dec_s = sum(eng._step_times[n_steps0:])
        proposer_reads = getattr(eng.proposer, "reads", None)
        kind = sp.proposer if proposer is None else "scripted"
        print(f"spec run {name} ({kind}, k={sp.max_draft}, pipeline="
              f"{sp.pipeline}, {max_new} new tokens): {st.spec_waves} verify "
              f"waves, {dec_tokens / st.spec_waves:.3f} tokens per wave "
              f"({dec_tokens / sum(w[0] for w in waves):.3f} per live slot), "
              f"acceptance "
              f"{st.acceptance_rate:.4f}, pipeline hit rate "
              f"{st.pipeline_hit_rate:.4f}, spec_window_steps "
              f"{eng.store.stats().spec_window_steps:.4f}; K1 "
              f"{launches['engram_gather']}, K2 {launches['gated_fuse']} "
              f"launches; reads per step {pulls}"
              + (f", draft reads {proposer_reads}"
                 if proposer_reads is not None else "")
              + "; tokens equal to the serve run's; no other sync")
        print(f"spec run {name} [{smi}]: decode {dec_tokens / dec_s:.2f} "
              f"tok/s ({dec_tokens} tokens in {dec_s * 1e3:.1f} ms of verify "
              f"waves, {dec_s * 1e3 / st.spec_waves:.1f} ms per wave), mean "
              f"TTFT {st.mean_ttft_s * 1e3:.2f} ms, run {run_s:.2f} s, peak "
              f"memory {peak / 1e9:.2f} GB")
        for k in total:
            total[k] += launches[k]
        if name == "a":
            del eng._spec_wave            # the method again, uncounted
            profile_waves(eng, rt, prompts, max_new=13, label="spec profile")
        # ``counted`` holds the engine through its default argument
        del eng, rt, handles, counted
    return total


# ---------------------------------------------------------------------------
# phases 11-12: overload and the storage tiers at full width
# ---------------------------------------------------------------------------

class KVTimer:
    """CUDA events around each preemption's snapshot (device->host) and
    each restore's upload and scatter (``restore_prefix`` to the
    ``update_slots`` that writes it), recorded without a sync and read
    after the run; beside each restore, the host time spent inside
    ``restore_prefix`` (pinning, copy and pad enqueues)."""

    def __init__(self, eng):
        import torch
        from repro_torch.serving import engine as engine_mod
        self.mod, self.spills, self.restores = engine_mod, [], []
        self._orig = (eng.preempt, engine_mod.restore_prefix,
                      engine_mod.update_slots)
        preempt, restore_prefix, update_slots = self._orig
        ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
        pending = []

        def timed_preempt(slot):
            req = eng.slots[slot]
            a, b = ev(), ev()
            a.record()
            ok = preempt(slot)
            b.record()
            if ok:
                self.spills.append((a, b, eng._spilled[req.rid].nbytes))
            return ok

        def timed_restore(snapshot, max_len, device):
            a = ev()
            a.record()
            t0 = time.perf_counter()
            out = restore_prefix(snapshot, max_len, device)
            pending.append((a, sum(t.numel() * t.element_size() for t in
                                   _leaves(snapshot)),
                            time.perf_counter() - t0))
            return out

        def timed_update(state, new_state, slots):
            out = update_slots(state, new_state, slots)
            if pending:
                a, nbytes, host_s = pending.pop()
                b = ev()
                b.record()
                self.restores.append((a, b, nbytes, host_s))
            return out

        self.eng = eng
        eng.preempt = timed_preempt
        engine_mod.restore_prefix = timed_restore
        engine_mod.update_slots = timed_update

    def close(self) -> tuple[list, list]:
        """Undo the wrapping; (ms, bytes) per spill and (ms, bytes, host
        ms in ``restore_prefix``) per restore."""
        del self.eng.preempt
        self.mod.restore_prefix, self.mod.update_slots = self._orig[1:]
        return ([(a.elapsed_time(b), n) for a, b, n in self.spills],
                [(a.elapsed_time(b), n, 1e3 * h)
                 for a, b, n, h in self.restores])


def _leaves(tree):
    from repro_torch.models.params import tree_leaves
    return list(tree_leaves(tree))


def ttft_by_class(handles) -> str:
    """Mean TTFT per SLO class: host clock (submit to first token) and
    virtual clock."""
    out = []
    for klass in sorted({h.request.slo for h in handles}):
        rs = [h.request for h in handles if h.request.slo == klass]
        wall = sum(r.first_token_s - r.submitted_s for r in rs) / len(rs)
        virt = sum(r.first_token_v - r.submitted_v for r in rs) / len(rs)
        out.append(f"{klass} {wall * 1e3:.2f} ms (virtual "
                   f"{virt * 1e3:.4f} ms, {len(rs)} requests)")
    return ", ".join(out)


def serve_overload(cfg, params, dev, smi: str, prompts, streams,
                   emulate_step_s: float = 5e-5) -> dict:
    """Overload at full width: ``OverloadPolicy()``, ``PoolArbiter(
    kv_cache_share=0.25)``, phase 9's TinyLFU hot-row cache of 2**20 rows,
    at the emulated operating point (the KV transfers are booked on the
    CXL link). (a) Phase 7's 8 prompts as batch requests of 16 new tokens;
    after the 4th decode wave 2 interactive requests (prompts 0 and 1, 8
    new tokens) preempt 2 of them. (b) Idle spill, no policy: 12 requests
    of 16 new tokens (the 8 prompts, then prompts 0 to 3) into 8 slots.
    Every stream must be phase 7's (its first 8 tokens for an interactive
    request); (a) must preempt and resume twice, spill and restore the
    same bytes, launch K1 once per decode wave, read once per preemption
    on top of the reference's budget and sync nowhere else. Returns the
    kernels' launches summed over both runs."""
    import torch
    from repro_torch.configs import StoreConfig
    from repro_torch.pool import PoolArbiter
    from repro_torch.pool.tiers import TIERS
    from repro_torch.serving import Engine, OverloadPolicy

    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=1 << 20,
                                      admission="tinylfu")))
    total = {"engram_gather": 0, "gated_fuse": 0}
    cxl_Bps = TIERS["CXL"].bandwidth_Bps
    for run in ("a", "b"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kw = dict(slo_policy=OverloadPolicy(),
                  arbiter=PoolArbiter(kv_cache_share=0.25)) if run == "a" \
            else dict(idle_spill_tokens=4)
        eng = Engine(ccfg, params=params, pool="CXL", max_batch=8,
                     max_len=512, prompt_bucket=32, device=dev,
                     emulate_step_s=emulate_step_s, **kw)
        eng.warmup(prompts)          # phase 7's 8 x 32 prefill group
        eng.store.reset_stats()
        rt = eng.runtime()
        timer = KVTimer(eng)
        marks = []
        handles = []

        def on_step():
            st = eng.stats
            marks.append((st.d2h_pulls, st.preemptions, st.resumes,
                          st.prefill_waves, st.decode_steps))
            if run == "a" and st.decode_steps == 4 and len(handles) == 8:
                handles.extend(rt.submit(p, max_new=8, slo="interactive")
                               for p in prompts[:2])

        reset_launches()
        if run == "a":
            handles += [rt.submit(p, max_new=16, slo="batch")
                        for p in prompts]
        else:
            handles += [rt.submit(p, max_new=16)
                        for p in prompts + prompts[:4]]
        pulls, run_s = drive(eng, rt, on_step=on_step)
        launches = read_launches()
        st = eng.stats
        on_step()
        spills, restores = timer.close()
        want = [streams[i] for i in range(len(prompts))]
        if run == "a":
            want += [s[:8] for s in streams[:2]]
        else:
            want += streams[:4]
        got = [h.tokens for h in handles]
        check(got == want, f"overload run {run}: streams {got} differ from "
              f"phase 7's {want}")
        check(launches["engram_gather"] == st.decode_steps,
              f"overload run {run}: K1 launches {launches['engram_gather']} "
              f"!= one per {st.decode_steps} decode waves")
        check(launches["gated_fuse"] == 2 * (st.prefill_waves
                                             + st.decode_steps),
              f"overload run {run}: K2 launches {launches['gated_fuse']} != "
              f"2 x ({st.prefill_waves} prefill groups + {st.decode_steps} "
              f"waves)")
        # per step: one read per decode wave and admission group, one per
        # preemption (the snapshot), one for the keys of a decode wave
        # after an admission or a restore (the reference's budget)
        deltas = [[y - x for x, y in zip(a, b)]
                  for a, b in zip(marks, marks[1:])]
        want_reads = [dec + pre + groups
                      + int(dec > 0 and (groups > 0 or res > 0))
                      for _, pre, res, groups, dec in deltas]
        check(pulls == want_reads, f"overload run {run}: reads per step "
              f"{pulls}, want {want_reads}")
        check(st.kv_spill_bytes == st.kv_restore_bytes
              == sum(n for _, n in spills)
              == sum(n for _, n, _ in restores),
              f"overload run {run}: spilled {st.kv_spill_bytes} B, restored "
              f"{st.kv_restore_bytes} B, snapshots {spills} / {restores}")
        check(eng.store.stats().class_bytes.get("kv", 0)
              == st.kv_spill_bytes + st.kv_restore_bytes,
              f"overload run {run}: class_bytes['kv'] "
              f"{eng.store.stats().class_bytes.get('kv', 0)} != spill + "
              f"restore bytes")
        if run == "a":
            check(st.preemptions == st.resumes == 2
                  and eng.kv_pool.stats().refused == 0,
                  f"overload run a: {st.preemptions} preemptions, "
                  f"{st.resumes} resumes, {eng.kv_pool.stats().refused} "
                  f"refused")
        else:
            check(st.idle_spills >= 1 and st.resumes == st.idle_spills,
                  f"overload run b: {st.idle_spills} idle spills, "
                  f"{st.resumes} resumes")
        peak = torch.cuda.max_memory_allocated()
        cache = eng.store.cache
        what = (f"OverloadPolicy + PoolArbiter(0.25), {len(handles)} "
                f"requests into 8 slots: {st.preemptions} preemptions"
                if run == "a" else
                f"idle_spill_tokens=4, {len(handles)} requests into 8 slots:"
                f" {st.idle_spills} idle spills")
        print(f"overload run {run}: {what}, "
              f"{st.resumes} resumes, {st.kv_spill_bytes} B spilled and "
              f"restored in {st.kv_spill_pages} pages, {st.decode_steps} "
              f"decode waves; K1 {launches['engram_gather']}, K2 "
              f"{launches['gated_fuse']} launches; reads per step {pulls}; "
              f"hot-row cache evictions {cache.evictions}, hit rate "
              f"{eng.store.stats().hit_rate:.4f}; streams equal to phase "
              f"7's; no other sync")
        for i, (ms, n) in enumerate(spills):
            print(f"overload run {run} [{smi}]: spill {i + 1}: {n} B "
                  f"device->host in {ms:.3f} ms ({n / ms / 1e6:.3f} GB/s); "
                  f"booked on the CXL link {n / cxl_Bps * 1e3:.4f} ms")
        for i, (ms, n, host_ms) in enumerate(restores):
            print(f"overload run {run} [{smi}]: restore {i + 1}: {n} B "
                  f"host->device + scatter in {ms:.3f} ms "
                  f"({n / ms / 1e6:.3f} GB/s; {host_ms:.3f} ms of host "
                  f"time in restore_prefix); booked on the CXL link "
                  f"{n / cxl_Bps * 1e3:.4f} ms")
        print(f"overload run {run} [{smi}]: mean TTFT {ttft_by_class(handles)}"
              f"; run {run_s:.2f} s, peak memory {peak / 1e9:.2f} GB")
        for k in total:
            total[k] += launches[k]
        del eng, rt, handles, timer, on_step
    return total


def serve_tiers(cfg, params, dev, smi: str, prompts, streams,
                emulate_step_s: float = 5e-5) -> dict:
    """The storage tiers at full width, phase 7's prompts, 8 new tokens,
    at the emulated operating point: (a) a ``CXL+SSD`` chain (front 2**16
    rows, warm 2**18 rows, sketch half-life 1e-4 s); (b) a 4-node fabric,
    node 1 degraded 4x after decode wave 2 and node 2 killed after wave 4.
    Both must emit phase 7's first 8 tokens, launch K1 once per decode
    wave and read once per steady wave; every chain wave's front, warm and
    cold rows must add up to its segments, and the fabric's stats must
    hold the rescue window. Returns the kernels' launches over both."""
    import torch
    from repro_torch.configs import StoreConfig
    from repro_torch.serving import Engine

    total = {"engram_gather": 0, "gated_fuse": 0}
    for run in ("a", "b"):
        gc.collect()
        torch.cuda.empty_cache()
        if run == "a":
            c = dataclasses.replace(cfg, engram=dataclasses.replace(
                cfg.engram, store=StoreConfig(cache_rows=1 << 16,
                                              warm_rows=1 << 18,
                                              aging_half_life_s=1e-4)))
            eng = Engine(c, params=params, pool="CXL+SSD", max_batch=8,
                         max_len=512, prompt_bucket=32, device=dev,
                         emulate_step_s=emulate_step_s)
        else:
            eng = Engine(cfg, params=params, pool="CXL", fabric_nodes=4,
                         max_batch=8, max_len=512, prompt_bucket=32,
                         device=dev, emulate_step_s=emulate_step_s)
        rt = eng.runtime()
        routes = []
        prefetch = eng.store.prefetch

        def routed(tokens, fetch=None):
            h = prefetch(tokens, fetch=fetch)
            routes.append((h.n_segments, h.shards))
            return h

        eng.store.prefetch = routed
        events = []

        def on_step():
            fab, n = eng.fabric, eng.stats.decode_steps
            if fab is None or events.count(n):
                return
            if n == 2:
                fab.degrade(1, 4.0)
                events.append(n)
            elif n == 4:
                fab.kill(2)
                events.append(n)

        reset_launches()
        handles = [rt.submit(p, max_new=8) for p in prompts]
        pulls, run_s = drive(eng, rt, on_step=on_step)
        launches = read_launches()
        del eng.store.prefetch
        st, ss = eng.stats, eng.store.stats()
        got = [h.tokens for h in handles]
        want = [s_[:8] for s_ in streams]
        check(got == want, f"tiers run {run}: streams {got} differ from "
              f"phase 7's {want}")
        check(launches["engram_gather"] == st.decode_steps,
              f"tiers run {run}: K1 launches {launches['engram_gather']} != "
              f"one per {st.decode_steps} decode waves")
        check(launches["gated_fuse"] == 2 * (st.prefill_waves
                                             + st.decode_steps),
              f"tiers run {run}: K2 launches {launches['gated_fuse']}")
        check(pulls == [3] + [1] * (st.decode_steps - 1),
              f"tiers run {run}: reads per step {pulls}")
        if run == "a":
            check(all(sum(r[:3]) == n for n, r in routes),
                  f"tiers run a: a wave's front + warm + cold rows differ "
                  f"from its segments: {routes}")
            seg = ss.hits + ss.warm_hits + ss.cold_misses
            check(seg == ss.segments and ss.cold_misses > 0,
                  f"tiers run a: front {ss.hits} + warm {ss.warm_hits} + "
                  f"cold {ss.cold_misses} != {ss.segments} segments")
            print(f"tiers run a (CXL+SSD chain, front 2**16, warm 2**18 "
                  f"rows, half-life 1e-4 s): {st.decode_steps} decode waves, "
                  f"{len(routes)} charged fetches; hit fractions front "
                  f"{ss.hits / seg:.4f}, warm {ss.warm_hits / seg:.4f}, "
                  f"cold {ss.cold_misses / seg:.4f} of {seg} segments; "
                  f"{ss.promotions} promotions, {ss.demotions} demotions; "
                  f"K1 {launches['engram_gather']}, K2 "
                  f"{launches['gated_fuse']}; reads per step {pulls}; "
                  f"streams equal to phase 7's")
        else:
            fs = eng.fabric.stats()
            check(events == [2, 4] and fs["rescues"] and not fs["alive"][2]
                  and fs["degrade"][1] == 4.0,
                  f"tiers run b: fabric events {fs['events']}")
            t_kill = fs["rescues"][0]["t_kill"]
            done = max(r["done_s"] for r in fs["rescues"])
            check(done > t_kill, f"tiers run b: no rescue window "
                  f"({t_kill} to {done})")
            nodes = {n.split(":")[1]: (v["reservations"], v["bytes"],
                                       v["busy_s"], v["wait_s"])
                     for n, v in fs["links"].items()}
            print(f"tiers run b (4-node fabric, node 1 degraded 4x after "
                  f"wave 2, node 2 killed after wave 4): {st.decode_steps} "
                  f"decode waves; shards moved {fs['events'][-1]['moved']} "
                  f"to {[r['dst'] for r in fs['rescues']]}, rescue window "
                  f"{t_kill:.6f} to {done:.6f} s (virtual); per link "
                  f"(reservations, bytes, busy s, wait s) {nodes}; K1 "
                  f"{launches['engram_gather']}, K2 "
                  f"{launches['gated_fuse']}; reads per step {pulls}; "
                  f"streams equal to phase 7's")
        print(f"tiers run {run} [{smi}]: stall per wave "
              f"{ss.stall_s_per_wave * 1e6:.3f} us (virtual, {ss.waves} "
              f"charged waves), emulated "
              f"{st.generated_tokens / st.emu_time_s:.1f} tokens/s; "
              f"run {run_s:.2f} s")
        for k in total:
            total[k] += launches[k]
        del eng, rt, handles, routed, on_step
    return total


# ---------------------------------------------------------------------------
# phase 13: the fleet (router, serve, Table 2) at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fleet_recorder():
    """Record, for any drive of a ``Router`` or of ``serve()``, each
    engine's reads, admission groups and decode waves per runtime step and
    the order in which the replicas' schedulers charged their waves; under
    PyTorch's sync debug mode, so a sync outside the counted reads fails.
    ``rec["seconds"]`` is the drive's host-clock time."""
    import torch
    from repro_torch.pool.scheduler import PrefetchScheduler
    from repro_torch.serving.runtime import EngramRuntime
    rec = {"steps": {}, "order": [], "seconds": 0.0}
    rt_step, charge = EngramRuntime.step, PrefetchScheduler.step

    def step(self):
        st = self.engine.stats
        a = (st.d2h_pulls, st.prefill_waves, st.decode_steps)
        events = rt_step(self)
        st = self.engine.stats
        rec["steps"].setdefault(self.engine.name, []).append(
            (st.d2h_pulls - a[0], st.prefill_waves - a[1],
             st.decode_steps - a[2]))
        return events

    def charged(self, *args, **kw):
        rec["order"].append(self)
        return charge(self, *args, **kw)

    EngramRuntime.step, PrefetchScheduler.step = step, charged
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield rec
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
    finally:
        EngramRuntime.step, PrefetchScheduler.step = rt_step, charge
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    check(not syncs, f"{len(syncs)} stray syncs in the fleet: {syncs[:3]}")


def check_fleet_steps(rec, engines, launches, label: str) -> dict:
    """Per replica: one read per decode wave and admission group, plus one
    for the keys of a decode wave after an admission (the single-engine
    budget, per busy replica); K1 once per decode wave and K2 twice per
    decode wave and admission group, summed over the replicas. Returns
    each replica's reads per step."""
    waves = sum(e.stats.decode_steps for e in engines)
    groups = sum(e.stats.prefill_waves for e in engines)
    check(launches["engram_gather"] == waves,
          f"{label}: K1 launches {launches['engram_gather']} != one per "
          f"{waves} decode waves of the replicas")
    check(launches["gated_fuse"] == 2 * (groups + waves),
          f"{label}: K2 launches {launches['gated_fuse']} != 2 x ({groups} "
          f"admission groups + {waves} decode waves)")
    reads = {}
    for eng in engines:
        steps = rec["steps"].get(eng.name, [])
        got = [r for r, _, _ in steps]
        want = [dec + grp + int(dec > 0 and grp > 0) for _, grp, dec in steps]
        check(got == want, f"{label}: {eng.name} reads per step {got}, "
              f"want {want}")
        reads[eng.name] = got
    return reads


def group_streams(cfg, params, dev, prompts, streams, groups,
                  max_new: int = 8) -> dict:
    """Each prompt's first ``max_new`` tokens when admitted in a group of
    a given row count, from one engine with phase 7's shapes that serves
    each group alone: ``(size, prompt index) -> tokens``. A row's prefill
    depends only on its prompt and its group's row count; decode rows
    depend on neither (phase 11's finding). Groups of 8 are phase 7's."""
    from repro_torch.serving import Engine
    out = {(len(prompts), i): s_[:max_new] for i, s_ in enumerate(streams)}
    eng = Engine(cfg, params=params, pool="CXL", max_batch=8, max_len=512,
                 prompt_bucket=32, device=dev)
    for g in sorted(groups):
        if all((len(g), i) in out for i in g):
            continue
        rids = [eng.submit(prompts[i], max_new=max_new) for i in g]
        eng.run()
        for i, rid in zip(g, rids):
            out[(len(g), i)] = eng.done.pop(rid).out
    return out


def flip_witness(cfg, params, dev, smi: str, prompts, streams,
                 group=(0, 2, 4, 6), at=(4, 3)) -> None:
    """Prompt ``at[0]`` admitted in phase 7's group of 8 x 32 tokens and in
    the group of 4 x 32 that a round-robin fleet of two gives it
    (``group``), each with K2 and with its plain version in K2's place:
    the token each emits at position ``at[1]`` and the top-2 f32 logits
    of the row that chose it. Where the group of 4 leaves phase 7's
    stream, a margin of the order of bf16 rounding, phase 7's token the
    runner-up, says a near-tie flipped; the plain K2 (no K2 launch) says
    whether K2 is what flips it. Launches here are not counted."""
    from repro_torch.core import engram as core_engram
    from repro_torch.kernels.gated_fuse import gated_fuse_ref
    from repro_torch.serving import Engine
    p, pos = at
    k2 = core_engram.engram_gated_fuse
    rows = {}
    try:
        for name, fuse in (("K2", k2), ("plain K2", gated_fuse_ref)):
            core_engram.engram_gated_fuse = fuse
            for g in (tuple(range(len(prompts))), group):
                eng = Engine(cfg, params=params, pool="CXL", max_batch=8,
                             max_len=512, prompt_bucket=32, device=dev)
                waves = []
                decode = eng._decode_ext_fn

                def recording(*args, _decode=decode, _eng=eng, _w=waves):
                    logits, state = _decode(*args)
                    _w.append((logits, [r.rid if r is not None else None
                                        for r in _eng.slots]))
                    return logits, state
                eng._decode_ext_fn = recording
                rid = [eng.submit(prompts[i], max_new=pos + 1)
                       for i in g][g.index(p)]
                reset_launches()
                eng.run()
                launched = read_launches()["gated_fuse"]
                check((launched > 0) == (fuse is k2),
                      f"witness: {name}, group {g}: {launched} K2 launches")
                tok = eng.done[rid].out[pos]
                logits, slots = waves[pos - 1]     # token 0 is prefill's
                row = logits[slots.index(rid)].float()
                top = row.topk(2)
                idx, vals = top.indices.tolist(), top.values.tolist()
                check(idx[0] == tok, f"witness: {name}, group {g}: the "
                      f"row's argmax {idx[0]} is not the token {tok}")
                rows[(name, len(g))] = (tok, idx, vals, row)
                del eng, waves, logits
                gc.collect()
    finally:
        core_engram.engram_gated_fuse = k2
    check(rows[("K2", len(prompts))][0] == streams[p][pos],
          f"witness: prompt {p} in phase 7's group emitted "
          f"{rows[('K2', len(prompts))][0]} at {pos}, phase 7 "
          f"{streams[p][pos]}")
    for (name, n), (tok, idx, vals, row) in rows.items():
        whose = "phase 7's" if tok == streams[p][pos] else "not phase 7's"
        delta = (row - rows[("K2", n)][3]).abs().max().item()
        print(f"fleet witness [{smi}]: prompt {p} in a group of {n} x 32 "
              f"with {name}: token {pos} is {tok} ({whose}), top-2 logits "
              f"{idx[0]}: {vals[0]:.6f}, {idx[1]}: {vals[1]:.6f}, margin "
              f"{vals[0] - vals[1]:.6f}; max |logit - K2's| over the row "
              f"{delta:.6f}")


def serve_fleet(cfg, params, dev, smi: str, prompts, streams,
                emulate_step_s: float = 5e-5) -> dict:
    """The fleet at full width over phase 7's parameter set, engine shapes
    and prompts, ``pool="CXL"``: (a) a 2-replica ``Router``
    (``round_robin``) with phase 9's TinyLFU hot-row cache of 2**20 rows
    mounted as ONE ``SharedCache``: the 8 prompts twice each, 16 new
    tokens, then again in an order that sends each prompt to the other
    replica; the same with private caches as the baseline; (b) ``serve()``
    of 16 poisson requests (8 new tokens) over 2 ``least_loaded`` replicas
    at the emulated point; (c) Table 2: ``serve()`` of the 8 prompts, 8
    new tokens, one replica, for DRAM, CXL and RDMA at the emulated point.
    Streams must be phase 7's (cut to their length; in (b), where arrivals
    set the admission groups, a single engine's at the same group size);
    K1 once per decode wave and K2 twice per wave and admission group of
    every replica; one read per busy replica per steady wave and no other
    sync; the shared cache must out-hit the private ones; every replica
    holds the fleet's one f32 head; in (b) the replicas' traces replayed
    together must give each its accounted stall exactly; (d) the near-tie
    that a group of 4 rows flips (``flip_witness``). Returns the kernels'
    launches summed over the runs (not (d)'s)."""
    import torch
    from repro_torch.configs import StoreConfig
    from repro_torch.models.layers import with_f32_head
    from repro_torch.pool.simulator import (replay_fleet_stall_s,
                                            replay_stall_s)
    from repro_torch.serving import Router, Workload, serve

    ccfg = dataclasses.replace(cfg, engram=dataclasses.replace(
        cfg.engram, store=StoreConfig(cache_rows=1 << 20,
                                      admission="tinylfu")))
    fleet_params = with_f32_head(params)       # the fleet's one f32 head
    w32 = fleet_params["head"]["w32"]
    kw = dict(params=fleet_params, device=dev, max_batch=8, max_len=512,
              prompt_bucket=32)
    total = {"engram_gather": 0, "gated_fuse": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def heads_shared(engines, label):
        check(all(e.params["head"]["w32"] is w32 for e in engines),
              f"{label}: a replica holds its own f32 head")

    # (a) shared hot-row cache against private ones. Each prompt goes in
    # twice per round, so each replica admits one group of 8 x 32 tokens,
    # phase 7's shape: in bf16 a prefill row depends on the group's row
    # count, and a 4 x 32 group flips a near-tie of phase 7's streams
    # (measured in (d), with K2 and with its plain version)
    n = len(prompts)
    swap = [i ^ 1 for i in range(n)]                # 1, 0, 3, 2, ...
    hits = {}
    for shared in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        router = Router(ccfg, replicas=2, pool="CXL", policy="round_robin",
                        shared_cache=shared, **kw)
        engines = [rt.engine for rt in router.replicas]
        heads_shared(engines, "fleet run a")
        label = f"fleet run a ({'shared' if shared else 'private'})"
        rounds = []
        for rnd, order in enumerate((list(range(n)) * 2, swap * 2)):
            for e in engines:
                e.reset_stats()
            reset_launches()
            with fleet_recorder() as rec:
                hs = [router.submit(prompts[i], max_new=16) for i in order]
                router.drain()
            launches = read_launches()
            add(launches)
            got = [h.tokens for h in hs]
            want = [streams[i] for i in order]
            check(got == want, f"{label} round {rnd + 1}: streams {got} "
                  f"differ from phase 7's {want}")
            where = {}
            for i, h in zip(order, hs):
                where.setdefault(i, set()).add(h.runtime.engine.name)
            reads = check_fleet_steps(rec, engines, launches,
                                      f"{label} round {rnd + 1}")
            agg = router.stats().aggregate
            rounds.append(where)
            print(f"{label} round {rnd + 1}: requests per replica "
                  f"{ {e.name: e.stats.prefills for e in engines} }, decode "
                  f"waves {[e.stats.decode_steps for e in engines]}; K1 "
                  f"{launches['engram_gather']}, K2 "
                  f"{launches['gated_fuse']} launches; reads per step "
                  f"{reads}; streams equal to phase 7's; no other sync")
            print(f"{label} round {rnd + 1} [{smi}]: host clock "
                  f"{rec['seconds']:.3f} s for {agg.generated_tokens} tokens "
                  f"({agg.generated_tokens / rec['seconds']:.2f} tokens/s, the"
                  f" replicas' waves one after another on one card); merged "
                  f"EngineStats.tokens_per_s {agg.tokens_per_s:.2f} (slowest "
                  f"replica's wall time {agg.wall_s:.3f} s: the parallel-"
                  f"hardware model, not a measurement)")
        check(all(len(rounds[0][i]) == 1 and rounds[0][i].isdisjoint(
            rounds[1][i]) for i in rounds[0]),
              f"{label}: round 2 did not move every prompt to the other "
              f"replica: {rounds}")
        if shared:
            cs = router.stats().cache
            hits[shared] = cs.hits
            per = {n: (v["hits"], v["misses"]) for n, v in
                   cs.per_view.items()}
        else:
            st = router.store_stats()
            hits[shared] = sum(x.hits for x in st.values())
            per = {n: (x.hits, x.misses) for n, x in st.items()}
        print(f"{label} [{smi}]: hot-row hits and misses per replica over "
              f"both rounds {per}, {hits[shared]} hits in all; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; one f32 "
              f"head for the fleet")
        del router, engines, hs
    check(hits[True] > hits[False],
          f"fleet run a: the shared cache's {hits[True]} hits do not exceed "
          f"the private caches' {hits[False]}")

    # (b) serve() over a poisson workload
    gc.collect()
    torch.cuda.empty_cache()
    wl = Workload(requests=16, max_new=8,
                  prompts=tuple(tuple(int(t) for t in p) for p in prompts),
                  arrival="poisson", qps=2e4, seed=0)
    reset_launches()
    with fleet_recorder() as rec:
        res = serve(ccfg, wl, pool="CXL", replicas=2, policy="least_loaded",
                    emulate_step_s=emulate_step_s, **kw)
    launches = read_launches()
    add(launches)
    router = res.router
    engines = [rt.engine for rt in router.replicas]
    heads_shared(engines, "fleet run b")
    # each request against its prompt's stream admitted in a group of the
    # same row count (phase 7's when 8): arrivals set the groups
    index = {tuple(int(t) for t in p): i for i, p in enumerate(prompts)}
    groups = {}
    for h in res.handles:
        key = (h.runtime.engine.name, h.request.first_token_v)
        groups.setdefault(key, []).append(index[tuple(h.request.prompt)])
    ref = group_streams(cfg, fleet_params, dev, prompts, streams,
                        {tuple(sorted(g)) for g in groups.values()})
    sizes = {h.rid: len(groups[(h.runtime.engine.name,
                                h.request.first_token_v)])
             for h in res.handles}
    got = [h.tokens for h in res.handles]
    want = [ref[(sizes[h.rid], index[tuple(h.request.prompt)])]
            for h in res.handles]
    check(got == want, f"fleet run b: streams {got} differ from the same "
          f"prompts admitted in groups of the same size {want}")
    same7 = sum(g == streams[index[tuple(h.request.prompt)]][:8]
                for g, h in zip(got, res.handles))
    reads = check_fleet_steps(rec, engines, launches, "fleet run b")
    # the replicas share the CXL link and the cache:shared link, so only
    # their traces replayed together, in charge order, see each other's
    # waits; a lone replay of one trace is a lower bound
    scheds = [e.scheduler for e in engines]
    who = [next(r for r, s_ in enumerate(scheds) if s_ is o)
           for o in rec["order"]]
    traces = [list(s_.trace) for s_ in scheds]
    layers = dict(layers=cfg.engram_layers(), n_layers=cfg.n_layers)
    fleet = replay_fleet_stall_s(ccfg.engram, "CXL", traces, who,
                                 shared_cache=True, **layers)
    replay = {}
    for eng, stall, trace in zip(engines, fleet, traces):
        solo = replay_stall_s(ccfg.engram, "CXL", trace, **layers)
        check(stall == eng.stats.stall_s,
              f"fleet run b: {eng.name} replays to {stall} s of stall, "
              f"accounted {eng.stats.stall_s} s")
        check(solo <= eng.stats.stall_s,
              f"fleet run b: {eng.name} alone replays to {solo} s, more "
              f"than the fleet's {eng.stats.stall_s} s")
        replay[eng.name] = (stall, solo)
    rs = router.stats()
    ttft = res.ttft_v()
    print(f"fleet run b (serve, 16 poisson requests at 2e4 qps, 2 replicas, "
          f"least_loaded, emulated step {emulate_step_s} s): "
          f"{rs.migrations} migrations, requests per replica "
          f"{ {n: st.prefills for n, st in rs.per_replica.items()} }, decode "
          f"waves {[e.stats.decode_steps for e in engines]}, admission "
          f"group sizes {sorted(len(g) for g in groups.values())}; K1 "
          f"{launches['engram_gather']}, K2 {launches['gated_fuse']}; reads "
          f"per step {reads}; streams equal to a single engine's at the same"
          f" group size ({same7} of 16 also equal to phase 7's, admitted 8 "
          f"at a time); stall per replica "
          f"(accounted = fleet replay; alone) "
          f"{ {n: (f'{a:.9f}', f'{b:.9f}') for n, (a, b) in replay.items()} }"
          f" s")
    print(f"fleet run b [{smi}]: mean virtual TTFT "
          f"{sum(ttft) / len(ttft) * 1e3:.4f} ms over {len(ttft)} requests, "
          f"RouterStats.cache_hit_rate {rs.cache_hit_rate:.4f}; host clock "
          f"{rec['seconds']:.3f} s for {rs.aggregate.generated_tokens} tokens"
          f" ({rs.aggregate.generated_tokens / rec['seconds']:.2f} tokens/s)"
          f"; merged tokens_per_s {rs.aggregate.tokens_per_s:.2f} (the "
          f"parallel-hardware model), tokens_per_s_emulated "
          f"{rs.aggregate.tokens_per_s_emulated:.1f}")
    del res, router, engines

    # (c) Table 2 at the emulated point
    table = {}
    wl = Workload(requests=len(prompts), max_new=8,
                  prompts=tuple(tuple(int(t) for t in p) for p in prompts))
    for pool in ("DRAM", "CXL", "RDMA"):
        gc.collect()
        torch.cuda.empty_cache()
        reset_launches()
        with fleet_recorder() as rec:
            res = serve(cfg, wl, pool=pool, replicas=1,
                        emulate_step_s=emulate_step_s, **kw)
        launches = read_launches()
        add(launches)
        eng = res.runtime.engine
        heads_shared([eng], f"fleet run c ({pool})")
        got = [h.tokens for h in res.handles]
        check(got == [s_[:8] for s_ in streams],
              f"fleet run c ({pool}): streams {got} differ from phase 7's")
        reads = check_fleet_steps(rec, [eng], launches,
                                  f"fleet run c ({pool})")
        table[pool] = res.stats
        print(f"fleet run c ({pool}): {res.stats.decode_steps} decode waves, "
              f"K1 {launches['engram_gather']}, K2 {launches['gated_fuse']};"
              f" reads per step {reads[None]}; stall "
              f"{res.stats.stall_s * 1e6:.3f} us (virtual); streams equal to "
              f"phase 7's")
        del res, eng
    print(f"fleet run c [{smi}]: tokens_per_s_emulated (the pool cost "
          f"model's clock, no CXL device) DRAM "
          f"{table['DRAM'].tokens_per_s_emulated:.3f}, CXL "
          f"{table['CXL'].tokens_per_s_emulated:.3f}, RDMA "
          f"{table['RDMA'].tokens_per_s_emulated:.3f}; CXL/DRAM "
          f"{table['CXL'].tokens_per_s_emulated / table['DRAM'].tokens_per_s_emulated:.4f}")

    # (d) what a group of 4 rows does to phase 7's streams
    gc.collect()
    torch.cuda.empty_cache()
    flip_witness(cfg, fleet_params, dev, smi, prompts, streams)
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.build import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {smi} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")
    print(f"device: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    logs = build(["engram_gather", "gated_fuse"])
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")

    cfg = get_config("engram-27b")
    k1 = check_k1(cfg, dev)
    k2 = check_k2(cfg, dev)
    check_agreement(dev)
    check_agreement_chunked(dev)
    check_agreement_spec(dev)
    check_agreement_overload(dev)
    check_agreement_tiers(dev)
    check_agreement_fleet(dev)
    params = draw_params(cfg, dev)
    launches, streams = serve_full(cfg, params, dev, smi)
    prompts = serve_prompts(cfg)
    for phase in (serve_long_prompt, serve_chunked,
                  lambda *a: serve_spec(*a, prompts, streams),
                  lambda *a: serve_overload(*a, prompts, streams),
                  lambda *a: serve_tiers(*a, prompts, streams),
                  lambda *a: serve_fleet(*a, prompts, streams)):
        gc.collect()             # the last phase's engine (a cycle with its
        torch.cuda.empty_cache()  # runtime) before the next one's caches
        for k, n in phase(cfg, params, dev, smi).items():
            launches[k] += n

    kernels = [
        dict(name="engram_gather", route="cuda",
             source="src/repro_torch/csrc/engram_gather.cu",
             replaces="src/repro/kernels/engram_gather/engram_gather.py:30",
             launches=launches["engram_gather"], **k1["wave"]),
        dict(name="gated_fuse", route="cuda",
             source="src/repro_torch/csrc/gated_fuse.cu",
             replaces="src/repro/kernels/gated_fuse/gated_fuse.py:36",
             launches=launches["gated_fuse"], **k2[8]),
    ]
    print("shapes: engram_gather at 2 tables x 128 rows (one decode wave, "
          "one launch; library_ms is two index_selects), gated_fuse at T=8 "
          "(decode, and each unrolled verify step); launches summed over "
          "the serve, long-prompt, chunked, spec, overload, tiers and fleet "
          "runs; also "
          "measured: "
          + json.dumps({"engram_gather_2x512_verify_wave": k1["spec"],
                        "engram_gather_N128_one_table": k1[16 * 8],
                        "engram_gather_N4096_one_table": k1[16 * 8 * 32],
                        "gated_fuse_T32": k2[32],
                        "gated_fuse_T64": k2[64],
                        "gated_fuse_T96": k2[96],
                        "gated_fuse_T128": k2[128],
                        "gated_fuse_T256": k2[256],
                        "gated_fuse_T2112": k2[2112]}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
