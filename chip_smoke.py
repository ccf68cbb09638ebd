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
              fabric stats and clock. And gemma2-27b-reduced and
              gemma3-1b-reduced (a 16-token window, softcaps, qk-norms,
              post-block norms, tied and scaled embeddings) on card and
              CPU: monolithic, chunked with a PrefixKVCache and scripted
              speculation, identical streams; teacher-forced logits over
              48 positions past the window (decode_window_slice off and
              on) within 1e-3. And deepseek-v2-236b-reduced and
              deepseek-v3-671b-reduced (MLA with its latent KV cache, MoE
              with shared experts) the same three ways, with StoreStats
              and PrefixCacheStats, and teacher-forced logits within 1e-3.
              And jamba-1.5-large-398b-reduced and xlstm-125m-reduced
              (Mamba, mLSTM and sLSTM state): monolithic with the prompts
              padded to their bucket (the pads reach the recurrent state,
              as in the reference: ROADMAP F11), chunked with a
              PrefixKVCache, and speculation with an always-wrong and an
              n-gram proposer, identical streams, StoreStats and
              PrefixCacheStats; teacher-forced logits within 0.5 % of the
              largest (``RECURRENT_FORCED_TOL``).
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
 14. host     the Engram tables in pinned, device-mapped host memory
              (``pooled_host``: K1 reads each row in place over the host
              link): (a) phase 7's tables copied into registered host
              buffers; K1 on host rows at the decode wave's 2 x 128 and the
              verify wave's 2 x 512 rows, bit-equal to its plain version and
              to K1 on the HBM copies, timed beside K1 from HBM, the
              reference's route (CPU index_select, then a non_blocking copy)
              and the byte bound at PCIe Gen5 x16's nominal 64 GB/s, with
              the link's rate measured by one large copy printed beside
              it; (b) engram-27b served with those host tables,
              phase 7's prompts and 16 new tokens: phase 7's streams, K1
              once per decode wave and once per Engram layer per admission
              group, one read per steady wave, the peak about the tables'
              23 GB below phase 7's; (c) deepseek-coder-33b (62 layers,
              33.5 B parameters on the card, its tables drawn into (b)'s
              buffers) and (d) engram-40b (40 layers, 74.2 GB of host
              tables) at full width, 8 prompts x 8 new tokens each, with K2
              held at their d (7168, 6144; T = 8, 256) and K1 bit-equal on
              each model's own host tables (a decode wave's ids, the last
              rows and rows past 4 GiB among them): launch and read
              budgets, peak device memory under 80 GB; between them, (e)
              gemma2-27b (46 layers, d 4608, a tied 256k vocabulary, 27.3
              B parameters on the card) from (b)'s buffers, serve's mix
              with 16 new tokens twice (identical streams), K2 held at d
              = 4608, K1 bit-equal on its host tables, every logit within
              its final softcap of 30.
 15. gemma3   gemma3-1b at full width and depth (26 layers, d 1152, a
              512-token window on 22 local layers), tables in HBM,
              ``pool="CXL"``: (c) K2 at d = 1152 (T = 8, 256, 2112); (a)
              a 2100-token prompt through monolithic admission, the
              local layers' chunked attention skipping the KV block
              before the window (counted), TTFT; (b) 8 prompts of 490 to
              510 tokens decoding 32 tokens across position 512, with
              ``decode_window_slice`` off and on: the waves' logits within
              16 bf16 ulps of each logit plus its row's RMS, the streams
              compared (where they part, the top-2 margin must be within
              that tolerance); each run's steady waves profiled.
 16. deepseek deepseek-v2-236b at full width (d 5120, 128 heads, MLA ranks
              1536 and 512, 160 routed experts top-6 and 2 shared of width
              1536, a 102,400-word vocabulary) cut to 9 layers (layer 0
              dense), 33.24 B parameters on the card, its ENGRAM_40B
              tables (layers 2 and 4) drawn into phase 14(d)'s registered
              host buffers, pooled_host; run right after 14(d): (a) K2
              at d = 5120, K1 bit-equal on its host tables, peak device
              memory under 80 GB; (b) phase 7's mix, 16 new tokens, twice
              after a warm-up: identical streams, K1, K2 and grouped-GEMM
              launch budgets, one read per steady wave, no other sync,
              then a profile listing the grouped GEMMs and the routing
              kernels; (c) a MoE layer at T = 8 and 256 against its
              plain per-expert loop (each grouped GEMM within one bf16
              ulp, the layer against an f32 evaluation), timed beside its
              byte bound, and the absorbed MLA decode timed; (d) MLA's
              absorbed decode held to its decompressed prefill on layers
              0 and 1's own weights (16 bf16 ulps of |out| + row RMS),
              a stacked layer's and the whole model's difference printed;
              (e) a 2100-token prompt at ``max_len=4096``, TTFT.
 17. jamba    jamba-1.5-large-398b at full width (d 8192, Mamba d_inner
              16384 with 16 states, 16 experts top-2 of width 24576)
              cut to 7 layers (mamba x 3, attn, mamba x 3; FFNs dense and
              MoE alternating; no layer stacked), 70.67 GB of weights on
              the card, its ENGRAM_40B tables (layers 2 and 3) drawn into
              phase 14(d)'s registered host buffers, pooled_host; run
              right after 16: (a) K2 at d = 8192, K1 bit-equal on its host
              tables, peak under 80 GB; (b) phase 7's mix, 16 new tokens,
              twice after a warm-up: identical streams, K1, K2 and
              grouped-GEMM budgets, one read per steady wave, no other
              sync, a profile; K1 timed on its host rows; (c) Mamba layer
              0 on its own weights: a decode step at B = 8 against an f32
              evaluation (``recurrent_layer``), a 32-token prefill against
              32 decode steps, timed beside its byte bound, and the Mamba
              layers' share of a wave's device time; (d) chunked
              (``prefill_chunk=16``) against monolithic admission on a
              32-token prompt: first-token logits within 16 bf16 ulps of
              |logit| + row RMS, where the streams part printed; (e) a
              2100-token prompt at ``max_len=4096``, TTFT beside the
              selective scan's host time.
 18. xlstm    xlstm-125m at full width and depth (12 layers, d 768, mLSTM
              and one sLSTM, no FFN, a tied head), tables in HBM (13.92
              GB, rows of 96 bf16), ``pool="CXL"``: K2 at d = 768 (T = 8,
              256), K1 bit-equal and timed at 192-byte rows; serve's mix
              twice, identical streams, every decode logit finite, phase
              7's budgets, a profile; the unstacked mLSTM layer 6 and the
              sLSTM layer 7 held and timed as in 17(c), with the xLSTM
              steps' share of a wave; 17(d)'s chunked check; a 512-token
              prompt's TTFT.

 19. hubert   hubert-xlarge at full width and depth (48 layers, d 1280, an
              audio frontend, no Engram, so no kernel of the port): the
              encoder step at B = 8 over seeded frames, S = 512 and 2100
              (the non-causal chunked path, 972 pad keys masked); the
              reference's draw's bf16 logits against f32 printed; on a
              unit-gain draw, bf16 against f32, chunked against dense,
              and frames at the end moving position 0's logits, held;
              device time, frames/s, peak memory.
 20. internvl internvl2-1b at full width and depth (24 layers, d 896, a
              vision stub of 256 patch tokens), ENGRAM_27B tables in HBM,
              a unit-gain draw: K2 at d = 896 (T = 8, 256) and K1 on its
              tables held and timed; serve's mix twice (phase 7's
              budgets, identical streams), a profile; a prefill with 256
              patch tokens: its logits moved by the patches, and within
              ``STACK_TOL`` of an f32 evaluation (the tree converted in
              place).
 21. cli      ``launch.serve.run_once`` (bf16 scores, the reference's
              serving default) on phase 7's engram-27b against the same
              workload through ``serve()`` with f32 scores: budgets,
              teacher-forced logits within 16 bf16 ulps of |logit| + row
              RMS, streams compared; 4 waves profiled each way and one
              layer's decode attention timed each way; a 40-token prompt
              by chunks of 16 in admission groups of 1, 4 and 8 rows, its
              first-token logits and streams compared (printed). Runs
              right after phase 13, before phase 14 frees phase 7's
              weights.

Phase 6 also runs reduced internvl2-1b like the other reduced configs,
reduced hubert-xlarge's encoder (dense and chunked) and internvl2-1b's
prefill with patch tokens card = CPU, and the overload and tier runs on
reduced jamba-1.5-large-398b and xlstm-125m.

The line before the last is a JSON object listing both kernels (launches
summed over phases 7 to 18, 20 and 21); the last is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
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
# f32 teacher-forced logits of the reduced recurrent configs over 48 steps
# (``forced_logits``), as a share of the largest logit: the stacked
# layers' states carry f32 rounding through the steps, and the port and
# the reference part by up to 0.23 % of it on the CPU (xLSTM; 0.02 % on
# jamba), a share tests/test_torch_mamba.py and tests/test_torch_xlstm.py
# hold
RECURRENT_FORCED_TOL = 5e-3


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


CUPTI_PRIME = 1024
CUPTI_LOST: list = []
CUPTI_ATTEMPTS = 3


class LostMarker(RuntimeError):
    """The profiler lost a session's marker record, so the session's
    device records cannot be told from its priming ones."""


@contextlib.contextmanager
def cupti_session(ops: list):
    """A CUDA-only profiler (CUPTI) session that appends to ``ops``, when
    it closes, every kernel, copy and fill that started on the card after
    its marker. The profiler loses the first device records of a session
    (on an H100 with torch 2.11: none to 297 of them, more as the process
    goes on, and once every one), so a session first runs ``CUPTI_PRIME``
    throwaway kernels and then a spin kernel as its marker, and raises
    ``LostMarker`` if the marker's record was lost too: its caller
    measures again in a new session (``CUPTI_ATTEMPTS`` in all). How many
    priming records each session lost goes to ``CUPTI_LOST``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CUPTI_PRIME):
            x.add_(1)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        yield
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    mark = [e for e in dev if "spin_kernel" in e.name]
    if len(mark) != 1:
        CUPTI_LOST.append(CUPTI_PRIME + 1)
        raise LostMarker("the profiler lost its marker record")
    end = mark[0].time_range.end
    CUPTI_LOST.append(CUPTI_PRIME + 1 - sum(e.time_range.start < end
                                            for e in dev))
    ops.extend(e for e in dev if e.time_range.start >= end)


def device_ops(fn, args_list, warmup: int = 3) -> list:
    """Every kernel, copy and fill the profiler records over ``args_list``
    (``cupti_session``), after ``warmup`` calls; a session that loses its
    marker is measured again in a new one (``CUPTI_ATTEMPTS`` in all)."""
    import torch
    for a in args_list[:warmup]:
        fn(*a)
    for attempt in range(CUPTI_ATTEMPTS):
        ops = []
        try:
            with cupti_session(ops):
                for a in args_list:
                    fn(*a)
            return ops
        except LostMarker:
            if attempt == CUPTI_ATTEMPTS - 1:
                raise
            # the lost attempt warmed the 50 MB L2 with the inputs: evict
            torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")


def device_ms(fn, args_list, warmup: int = 3,
              ops_per_call: int | None = None) -> float:
    """Mean device time per call: the durations of every kernel, copy and
    fill the profiler records over ``args_list`` (``device_ops``),
    summed, over the call count. Raises if it records no device time, or,
    with ``ops_per_call``, any other number of device operations than that
    many per call (a lost record would read as a faster call)."""
    ops = device_ops(fn, args_list, warmup)
    us = sum(e.time_range.elapsed_us() for e in ops)
    check(us > 0, "the profiler recorded no device time")
    if ops_per_call is not None:
        check(len(ops) == ops_per_call * len(args_list),
              f"the profiler recorded {len(ops)} device operations for "
              f"{len(args_list)} calls of {ops_per_call}")
    return us / 1e3 / len(args_list)


def top_kernels(ops, n: int = 4) -> str:
    """The ``n`` kernel names with the most device time in ``ops``, with
    their share of it."""
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return "; ".join(f"{100 * us / total:.1f} % {name[:60]}"
                     for name, us in top)


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
        ms = device_ms(gather_rows, [(flat, g) for g in cold((n,))],
                       ops_per_call=1)
        plain = device_ms(gather_rows_ref, [(flat, g) for g in cold((n,))])
        lib = device_ms(index_select, [(flat, g) for g in cold((n,))],
                        ops_per_call=1)
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
        ms = device_ms(gather_rows_multi, [(flats, g) for g in cold((L, n))],
                       ops_per_call=1)
        plain = device_ms(gather_rows_multi_ref,
                          [(flats, g) for g in cold((L, n))])
        lib = device_ms(per_layer, [(flats, g) for g in cold((L, n))],
                        ops_per_call=L)
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

def k2_operands(gen, dev, n_t, d, F, dtype):
    import torch
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    return (mk(n_t, d).to(dtype), mk(n_t, F).to(dtype),
            (mk(d, d) / math.sqrt(d)).to(dtype),
            (mk(F, d) / math.sqrt(F)).to(dtype))


def time_k2(gen, dev, n_t: int, d: int, F: int) -> dict:
    """K2 in bf16 at one shape against its plain version (one bf16 ulp,
    bit-identical across calls), device-timed with cold weights beside its
    bound and the plain version."""
    import torch
    from repro_torch.kernels.gated_fuse import (engram_gated_fuse,
                                                gated_fuse_ref)
    from repro_torch.kernels.gated_fuse.ops import plan_split
    # each timed call has its own weights (78.6 MB at d = 5120, beyond the
    # 50 MB L2): on the main path K2's weights are never warm
    sets = [k2_operands(gen, dev, n_t, d, F, torch.bfloat16)
            for _ in range(10)]
    out = engram_gated_fuse(*sets[0])
    ref = gated_fuse_ref(*sets[0])
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    check(torch.equal(out, engram_gated_fuse(*sets[0])),
          f"K2 not bit-identical across two calls at T={n_t} d={d}")
    err = (out.float() - ref.float()).abs().max().item()
    ms = device_ms(engram_gated_fuse, sets, ops_per_call=1)
    plain = device_ms(gated_fuse_ref, sets)
    nbytes = 2 * (2 * n_t * d + n_t * F + d * d + F * d)
    flops = 2 * n_t * d * (d + F)
    b_ms, b_by = bound(nbytes, flops)
    check(ms >= b_ms, f"K2 at T={n_t} d={d}: {ms:.5f} ms is below its "
          f"bound {b_ms:.6f} ms: the timing is at fault")
    plan = plan_split(n_t, d, F)
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
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)


def check_k2(cfg, dev) -> dict:
    import torch
    from repro_torch.kernels.gated_fuse import (engram_gated_fuse,
                                                gated_fuse_ref)
    d = cfg.d_model
    F = len(cfg.engram.orders) * cfg.engram.emb_dim
    gen = torch.Generator(device=dev).manual_seed(2)
    # decode batch; prefill groups of 1 to 4 x 32 tokens (the fleet's
    # admission groups); 8 x 32-token prefill group; a 2100-token prompt
    result = {n_t: time_k2(gen, dev, n_t, d, F)
              for n_t in (8, 32, 64, 96, 128, 256, 2112)}
    for n_t, dd, ff, dtype, tol in ((5, 100, 36, torch.bfloat16, BF16_TOL),
                                    (13, 512, 264, torch.bfloat16, BF16_TOL),
                                    (37, 98, 30, torch.float32, F32_TOL),
                                    (40, 128, 64, torch.float32, F32_TOL)):
        ops = k2_operands(gen, dev, n_t, dd, ff, dtype)
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


def check_agreement_overload(dev, mod) -> None:
    """Overload on ``mod``'s reduced config at the emulated operating
    point, on the card and on the CPU: a TinyLFU hot-row cache,
    ``OverloadPolicy()`` and ``PoolArbiter(kv_cache_share=0.25)``; 4 batch
    requests, then 2 interactive ones after the third decode wave. The
    streams (equal to a run without the policy), the overload counters,
    KVPoolStats, StoreStats, the cache's evictions and the clock must be
    identical. On a recurrent config a preempted slot's snapshot carries
    its recurrent leaves whole."""
    import numpy as np
    from repro_torch.configs import StoreConfig
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.pool import PoolArbiter
    from repro_torch.serving import Engine, OverloadPolicy
    cfg = mod.reduced()
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
    print(f"agree overload: {cfg.name} (f32, pool=CXL, emulated "
          f"step 5e-5 s, TinyLFU cache of 2048 rows, OverloadPolicy, "
          f"PoolArbiter(kv_cache_share=0.25)), 4 batch + 2 interactive "
          f"requests into 4 slots: {pre} preemptions, {res} resumes, "
          f"{spill} B spilled and restored, cache evictions "
          f"{card['cache'][0]}; streams (equal to the run without the "
          f"policy), overload counters, KVPoolStats, StoreStats, cache and "
          f"clock identical on card and CPU")


def check_agreement_tiers(dev, mod) -> None:
    """The storage tiers on ``mod``'s reduced config at the emulated
    operating point, on the card and on the CPU: a ``CXL+SSD`` chain
    (front 64 rows, warm 512 rows, sketch half-life 2e-4 s) and a two-node
    fabric whose node 1 is killed after decode wave 2. StoreStats, the
    fabric's stats and the clock must be identical, and the streams equal
    to the card's run without tiers."""
    import numpy as np
    from repro_torch.configs import StoreConfig
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Engine
    cfg = mod.reduced()
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
    print(f"agree tiers: {cfg.name} (f32, emulated step 5e-5 s): "
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


def forced_logits(cfg, params, device, window_slice: bool) -> list:
    """Teacher-forced logits of a reduced config over 48 positions (past
    the reduced gemma configs' 16-token window): a 2-row prefill (16 and 11
    tokens) through chunked attention (8-token chunks, so local layers
    skip KV blocks), then 48 decode steps of seeded tokens at
    ``max_len=64``. Returns the prefill's and every step's logits."""
    import numpy as np
    import torch
    from repro_torch.models.model import build_decode_step, build_prefill_step
    from repro_torch.models.transformer import RunFlags
    flags = RunFlags(chunk_threshold=8, q_chunk=8, kv_chunk=8,
                     decode_window_slice=window_slice)
    rng = np.random.RandomState(7)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, size=(2, 16)))
    forced = torch.from_numpy(rng.randint(1, cfg.vocab_size, size=(48, 2)))
    logits, state = build_prefill_step(cfg, flags, max_len=64)(params, {
        "tokens": toks.to(device), "lengths": torch.tensor(
            [16, 11], device=device)})
    out = [logits]
    decode = build_decode_step(cfg, flags)
    for tok in forced:
        logits, state = decode(params, state, tok.to(device))
        out.append(logits)
    return [t.cpu() for t in out]


def check_agreement_models(dev, mods, slices=(False,),
                           recurrent: bool = False) -> None:
    """The reduced configs of ``mods`` (f32, pool CXL at the emulated
    operating point) on the card and on the CPU: monolithic serving of
    three prompts of 18 to 30 tokens, chunked admission
    (``prefill_chunk=8``) with a PrefixKVCache over three prompts sharing
    a 16-token head, served one at a time, and speculation with a
    ScriptedProposer over the monolithic streams: identical streams,
    StoreStats and PrefixCacheStats, the speculative streams equal to the
    monolithic, every draft accepted, prefix blocks restored. Random
    weights make flat streams, so the teacher-forced logits over 48
    positions (``forced_logits``, chunked prefill attention, each
    ``decode_window_slice`` of ``slices``) must also agree within 1e-3.
    gemma2-27b and gemma3-1b (a 16-token window: sliding-window layers,
    softcaps, qk-norms, post-block norms, tied and scaled embeddings) run
    with the slice off and on; deepseek-v2-236b and deepseek-v3-671b (MLA
    latents in the KV cache, MoE) without it. The logits are held within
    1e-3, or with ``recurrent`` within ``RECURRENT_FORCED_TOL`` of the
    largest logit. With ``recurrent``
    (jamba-1.5-large-398b and xlstm-125m: Mamba, mLSTM and sLSTM state)
    speculation runs twice instead, with an always-wrong proposer (every
    draft rejected, the recurrent state rolled back each wave) and the
    n-gram proposer, each emitting the monolithic streams; the monolithic
    prompts are padded to their bucket of 8, so the pad tokens reach the
    recurrent state on both devices (ROADMAP F11)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import SpecConfig
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_map
    from repro_torch.pool.cache import PrefixKVCache
    from repro_torch.serving import Engine
    from repro_torch.spec import (ConstantProposer, NGramProposer,
                                  ScriptedProposer)

    def run(eng, prompts, one_at_a_time=False):
        rids = []
        for p in prompts:
            rids.append(eng.submit(p, max_new=12))
            if one_at_a_time:
                eng.run()
        eng.run()
        return [eng.done[r].out for r in rids]

    for mod in mods:
        cfg = mod.reduced()
        params_cpu = init_params(cfg, seed=0, device="cpu")
        params_dev = tree_map(lambda t: t.to(dev), params_cpu)
        rng = np.random.RandomState(5)
        prompts = [list(rng.randint(1, cfg.vocab_size, size=n))
                   for n in (18, 23, 30)]
        head = list(rng.randint(1, cfg.vocab_size, size=16))
        shared = [head + list(rng.randint(1, cfg.vocab_size, size=n))
                  for n in (3, 7, 12)]
        kw = dict(pool="CXL", max_batch=2, max_len=64, prompt_bucket=8,
                  emulate_step_s=5e-5)
        seen, script = [], None
        for device, params in (("cpu", params_cpu), (dev, params_dev)):
            mono_eng = Engine(cfg, params=params, device=device, **kw)
            mono = run(mono_eng, prompts)
            script = script or [p + o for p, o in zip(prompts, mono)]
            chunked = Engine(cfg, params=params, device=device,
                             prefill_chunk=8,
                             prefix_cache=PrefixKVCache(64 << 20, 8), **kw)
            chunked_out = run(chunked, shared, one_at_a_time=True)
            proposers = ({"wrong": ConstantProposer(-1),
                          "ngram": NGramProposer(4)} if recurrent else
                         {"scripted": ScriptedProposer(script)})
            specs = {k: Engine(cfg, params=params, device=device,
                               spec=SpecConfig(max_draft=3), proposer=pr,
                               **kw) for k, pr in proposers.items()}
            seen.append(dict(
                mono=mono, chunked=chunked_out,
                spec={k: run(e, prompts) for k, e in specs.items()},
                hits=chunked.stats.prefix_hit_blocks,
                drafts={k: (e.stats.proposed_tokens, e.stats.accepted_tokens)
                        for k, e in specs.items()},
                store=[dataclasses.asdict(e.store.stats())
                       for e in (mono_eng, chunked, *specs.values())],
                prefix=dataclasses.asdict(chunked.prefix_cache.stats())))
        cpu, card = seen
        for key in cpu:
            check(cpu[key] == card[key],
                  f"{cfg.name} agreement: {key} differs: cpu {cpu[key]} vs "
                  f"card {card[key]}")
        for k, out in card["spec"].items():
            check(out == card["mono"], f"{cfg.name} agreement: speculative "
                  f"streams ({k} proposer) differ from the monolithic")
        check(card["hits"] > 0, f"{cfg.name} agreement: no prefix hit")
        drafts = "; ".join(f"{k}: {a}/{p} drafts accepted"
                           for k, (p, a) in card["drafts"].items())
        for k, (proposed, accepted) in card["drafts"].items():
            want = {"scripted": proposed, "wrong": 0}.get(k, accepted)
            check(proposed > 0 and accepted == want, f"{cfg.name} "
                  f"agreement: {accepted} of {proposed} {k} drafts accepted")
        worst = {}
        for ws in slices:
            ref = forced_logits(cfg, params_cpu, "cpu", ws)
            got = forced_logits(cfg, params_dev, dev, ws)
            # f32 sums in another order on the card, through the stack;
            # the recurrent configs' states carry that through 48 steps
            top = max(b.abs().max().item() for b in ref)
            atol = RECURRENT_FORCED_TOL * top if recurrent else 1e-3
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, rtol=1e-3, atol=atol)
            worst[ws] = max((a - b).abs().max().item()
                            for a, b in zip(got, ref))
        print(f"agree {cfg.name} (f32, pool=CXL, emulated step 5e-5 s"
              + (f", window {cfg.window_size}" if cfg.window_size else "")
              + f"): monolithic, chunked with a prefix cache "
              f"({card['hits']} blocks restored, {card['prefix']['bytes']} "
              f"snapshot bytes held) and speculation ({drafts}; streams "
              f"equal to the monolithic) identical on card and CPU, with "
              f"StoreStats and "
              f"PrefixCacheStats; teacher-forced logits over 48 positions, "
              + (f"held within {atol:.2e}, " if recurrent else "")
              + f"max|card - cpu| "
              + ", ".join(f"{v:.2e}" + (f" (decode_window_slice={ws})"
                                        if len(slices) > 1 else "")
                          for ws, v in worst.items()))


def check_agreement_frontends(dev) -> None:
    """The encoder and the vision stub on the card and on the CPU (f32):
    reduced hubert-xlarge's encoder logits over seeded frames (B 2, S 21)
    dense and chunked (``chunk_threshold`` 8, 8-token chunks, so the last
    KV chunk holds 3 pad keys that the non-causal mask must exclude), and
    reduced internvl2-1b's prefill logits with its 8 patch tokens (and
    without them), within 1e-3, as phase 5's."""
    import torch
    from repro_torch.configs import hubert_xlarge, internvl2_1b
    from repro_torch.models.model import (build_encoder_step,
                                          build_prefill_step, init_params)
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer import RunFlags
    worst = {}
    for mod in (hubert_xlarge, internvl2_1b):
        cfg = mod.reduced()
        params_cpu = init_params(cfg, seed=0, device="cpu")
        params_dev = tree_map(lambda t: t.to(dev), params_cpu)
        gen = torch.Generator().manual_seed(6)
        if cfg.is_encoder:
            batch = {"frames": torch.randn(2, 21, cfg.frontend_dim,
                                           generator=gen)}
            runs = {f"encoder {k}": build_encoder_step(cfg, RunFlags(**kw))
                    for k, kw in (("dense", {}),
                                  ("chunked", dict(chunk_threshold=8,
                                                   q_chunk=8, kv_chunk=8)))}
        else:
            tokens = torch.randint(1, cfg.vocab_size, (2, 16), generator=gen)
            tokens[:, :cfg.n_patch_tokens] = 0       # the image positions
            batch = {"tokens": tokens, "lengths": torch.tensor([16, 11]),
                     "patches": torch.randn(2, cfg.n_patch_tokens,
                                            cfg.frontend_dim, generator=gen)}
            pre = build_prefill_step(cfg, RunFlags(), max_len=32)
            runs = {"prefill with patches": lambda p, b: pre(p, b)[0],
                    "prefill without": lambda p, b: pre(p, {
                        k: v for k, v in b.items() if k != "patches"})[0]}
        for name, fn in runs.items():
            want = fn(params_cpu, batch)
            got = fn(params_dev, tree_map(lambda t: t.to(dev), batch)).cpu()
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
            worst[f"{cfg.name} {name}"] = (got - want).abs().max().item()
    print("agree frontends (f32): "
          + "; ".join(f"{k} max|card - cpu| {v:.2e}" for k, v in
                      worst.items())
          + " (hubert: S = 21, chunked with 8-token chunks: 3 pad keys "
          "masked in the last KV chunk)")


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
    the last run, that run's token streams and its decode-wave wall time
    and peak memory (``serve_once``)."""
    import torch
    from repro_torch.serving import Engine

    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params=params, pool="CXL", max_batch=8, max_len=512,
                 prompt_bucket=32, device=dev)
    prompts = serve_prompts(cfg)
    eng.warmup(prompts)              # the measured 8 x 32 prefill group
    rt = eng.runtime()
    for rep in range(reps):
        launches, streams, summary = serve_once(cfg, eng, rt, prompts, dev,
                                                smi, rep)
    profile_waves(eng, rt, prompts)
    return launches, streams, summary


def serve_once(cfg, eng, rt, prompts, dev, smi: str, rep: int) -> tuple:
    """One counted run of the main path: every request to completion with
    the kernels' launch counters and the engine's stats reset just before
    it; checks the counts, the reads per wave and the outputs. Returns the
    launches, the token streams and {wave_ms, peak_gb}: the mean decode
    wave's wall time and the peak device memory since the engine's
    caller reset it."""
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
    summary = dict(wave_ms=decode_s * 1e3 / st.decode_steps,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, [h.tokens for h in handles], summary


def profile_waves(eng, rt, prompts, max_new: int = 6,
                  label: str = "profile", groups=None) -> None:
    """Where a steady decode (or verify) wave's time goes, from a short
    extra run after the counted one: wall time per wave, device time per
    wave (CUPTI, all kernels summed) and the kernels that take most of it;
    with ``groups`` ({label: predicate on a kernel's name}) also each
    group's device time and operations per wave. The first step
    (admission, and in chunked mode the chunk waves) is not profiled.
    Returns the wall and device ms and the device operations per wave."""
    import torch
    for attempt in range(CUPTI_ATTEMPTS):
        for p in prompts:
            rt.submit(p, max_new=max_new)
        rt.step()                    # admission + the post-admission wave
        while eng._prefill_jobs:     # chunked: the rest of the prompts
            rt.step()
        torch.cuda.synchronize()
        waves0 = eng.stats.decode_steps
        ops = []
        try:
            with cupti_session(ops):
                t0 = time.perf_counter()
                while eng.busy:
                    rt.step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            break
        except LostMarker:           # the requests ran to their end
            if attempt == CUPTI_ATTEMPTS - 1:
                raise
    n = eng.stats.decode_steps - waves0
    dev_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    by_name = {}
    for e in ops:
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    check(n > 0, f"{label}: no wave left to profile")
    print(f"{label}: {n} steady waves under the profiler: wall "
          f"{wall_ms / n:.3f} ms/wave, device busy {dev_ms / n:.3f} ms/wave "
          f"({100 * dev_ms / wall_ms:.1f} % of wall), {len(ops) / n:.0f} "
          f"device kernels/copies per wave")
    for name, (calls, us) in top:
        print(f"{label}:   {us / 1e3 / n:9.4f} ms/wave  {calls / n:6.1f} "
              f"calls/wave  {name[:90]}")
    for g, pred in (groups or {}).items():
        hit = [(c, us) for name, (c, us) in by_name.items() if pred(name)]
        print(f"{label}: {g}: {sum(us for _, us in hit) / 1e3 / n:.4f} "
              f"ms/wave in {sum(c for c, _ in hit) / n:.1f} device "
              f"operations/wave ({len(hit)} kernel names)")
    return dict(wall_ms=wall_ms / n, dev_ms=dev_ms / n, ops=len(ops) / n)


def serve_long_prompt(cfg, params, dev, smi: str, flags=None,
                      label: str = "long prompt", n: int = 2100,
                      warm_n: int | None = None, info=None) -> dict:
    """One ``n``-token prompt (2100 by default, padded to 2112) through
    monolithic admission with ``max_len=4096``: every layer's prefill
    attention is chunked. After a warm-up with another prompt of
    ``warm_n`` tokens (default ``n``), one counted run with 8 new tokens;
    returns the kernels' launches over it, and puts its TTFT (ms) in
    ``info`` when given. With pooled_host ``flags`` K1 also launches once
    per Engram layer for the admission group."""
    import numpy as np
    import torch
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import Engine

    flags = flags or RunFlags()
    n_host = len(cfg.engram_layers()) \
        if flags.engram_strategy == "pooled_host" else 0
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params=params, flags=flags, pool="CXL", max_batch=8,
                 max_len=4096, prompt_bucket=32, device=dev)
    rng = np.random.RandomState(3)
    warm, prompt = (list(rng.randint(1, cfg.vocab_size, size=k))
                    for k in (warm_n or n, n))
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
          f"{label}: {h.tokens} is not 8 tokens of the vocabulary")
    check(st.decode_steps == 7 and launches["engram_gather"]
          == st.decode_steps + n_host * st.prefill_waves,
          f"{label}: K1 launches {launches['engram_gather']} != one per "
          f"{st.decode_steps} decode waves + {n_host} per prefill group")
    check(launches["gated_fuse"] == 2 * (st.prefill_waves + st.decode_steps),
          f"{label}: K2 launches {launches['gated_fuse']} != 2 x "
          f"({st.prefill_waves} prefill groups + {st.decode_steps} waves)")
    check(pulls == [3] + [1] * (st.decode_steps - 1),
          f"{label}: device->host reads per step {pulls}")
    kv = sum(t.numel() * t.element_size()
             for t in tree_leaves(eng.state["caches"]))
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: {n} tokens (bucket {-(-n // 32) * 32}) + 8 new, "
          f"monolithic admission after a {len(warm)}-token warm-up, "
          f"chunked attention in every attention layer; K1 "
          f"launches {launches['engram_gather']}, K2 launches "
          f"{launches['gated_fuse']}; reads per step {pulls}; no other sync")
    print(f"{label} [{smi}]: TTFT {st.mean_ttft_s * 1e3:.2f} ms, run "
          f"{run_s:.3f} s, peak memory {peak / 1e9:.2f} GB, decode state "
          f"{kv / 1e9:.2f} GB (max_batch 8 x max_len 4096)")
    if info is not None:
        info["ttft_ms"] = st.mean_ttft_s * 1e3
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


# ---------------------------------------------------------------------------
# phase 14: host tables (pooled_host) at full width
# ---------------------------------------------------------------------------

PCIE5_X16_BYTES_PER_S = 64e9     # PCIe Gen5 x16, nominal, one direction


def host_status(label: str) -> str:
    """Host memory registered for the card now, and the kernel's
    MemAvailable."""
    from repro_torch.kernels.engram_gather.host import pinned_bytes
    avail = next(int(line.split()[1]) * 1024 for line in
                 open("/proc/meminfo") if line.startswith("MemAvailable"))
    return (f"{label}: host pinned {pinned_bytes() / 1e9:.2f} GB, "
            f"MemAvailable {avail / 1e9:.2f} GB")


def host_facts(smi: str) -> None:
    """What phase 14 depends on: the machine's memory, the memlock limit
    (cudaHostRegister does not appear to be held to it here), and whether
    PyTorch's pinned allocator rounds a request up (why the tables get
    exact-size registered buffers instead)."""
    import resource

    import torch
    mem = {line.split(":")[0]: line.split()[1] for line in
           open("/proc/meminfo")}
    soft, hard = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    ask = (64 << 20) + (1 << 20)
    before = torch.cuda.host_memory_stats().get("allocated_bytes.current", 0)
    x = torch.empty(ask, dtype=torch.uint8, pin_memory=True)
    took = torch.cuda.host_memory_stats().get("allocated_bytes.current",
                                              0) - before
    del x
    print(f"host [{smi}]: MemTotal {mem['MemTotal']} kB, MemAvailable "
          f"{mem['MemAvailable']} kB, RLIMIT_MEMLOCK soft {soft} hard "
          f"{hard} B, {os.cpu_count()} cores; PyTorch's pinned allocator "
          f"took {took} B for a {ask} B request")


def link_rate(host_flat, dev) -> float:
    """Bytes/s of one large copy from a registered host buffer to the card
    (2 GiB, the best of 3 after one warm-up)."""
    import torch
    n = min(host_flat.numel(), 1 << 30)
    src = host_flat.view(-1)[:n]
    dst = torch.empty(n, dtype=src.dtype, device=dev)
    best = 0.0
    for rep in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        if rep:
            best = max(best, n * src.element_size()
                       / (start.elapsed_time(end) / 1e3))
    return best


def check_k1_host(cfg, hbm, host, dev, smi: str) -> dict:
    """(a) K1 reading rows in place from the host tables ``host`` (phase
    7's, just copied down) against its plain version on the same bytes
    (bit-equal) and against K1 on the HBM copies ``hbm``, at the decode
    wave's 2 x 128 rows and the verify wave's 2 x 512; timed beside K1 from
    HBM, the reference's route (CPU index_select on the pinned table, then
    a non_blocking copy to the card) and the byte bound at the host link's
    nominal peak (PCIe Gen5 x16); the link's rate measured in the run is
    printed and returned beside it, not used as a bound. Synchronises after every checked call: a trap on a host
    row shows only at the next sync."""
    import torch
    from repro_torch.kernels.engram_gather import (gather_rows_multi,
                                                   gather_rows_multi_ref)
    from repro_torch.kernels.engram_gather.host import device_pointer
    e = cfg.engram
    L = len(hbm)
    T, V, hd = hbm[0].shape
    hbm_f = [t.view(T * V, hd) for t in hbm]
    host_f = [t.view(T * V, hd) for t in host]
    row_bytes = hd * host[0].element_size()
    ptrs = [device_pointer(t) for t in host_f]
    check(all(p is not None and p % 16 == 0 for p in ptrs),
          f"host tables' device addresses {ptrs} not 16-byte aligned: K1 "
          f"would copy byte by byte")
    rate = link_rate(host_f[0], dev)
    print(f"host tables [{smi}]: {L} x {T} x {V} x {hd} "
          f"{host[0].dtype}; device address == host address "
          f"{ptrs == [t.data_ptr() for t in host_f]}; host->card "
          f"link {rate / 1e9:.2f} GB/s measured (one 2 GiB copy from a "
          f"registered buffer, best of 3), PCIe Gen5 x16 nominal "
          f"{PCIE5_X16_BYTES_PER_S / 1e9:.0f} GB/s")
    gen = torch.Generator(device=dev).manual_seed(14)

    def cold(n):
        return [torch.randint(0, T * V, (L, n), generator=gen, device=dev)
                for _ in range(40)]

    def ref_route(g_cpu, staging):
        for j in range(L):
            torch.index_select(host_f[j], 0, g_cpu[j], out=staging[j])
        return staging.to(dev, non_blocking=True)

    result = {}
    for key, n, what in (("wave", 16 * 8, "a decode wave"),
                         ("spec", 16 * 8 * 4, "a verify wave, B=8 m=4")):
        for g in cold(n)[:4]:
            out = gather_rows_multi(host_f, g)
            torch.cuda.synchronize()
            g_cpu = g.cpu()
            check(torch.equal(out.cpu().view(torch.int16),
                              gather_rows_multi_ref(host_f, g_cpu)
                              .view(torch.int16)),
                  f"K1 on host rows not bit-equal at {L} x {n}")
            check(torch.equal(out.view(torch.int16),
                              gather_rows_multi(hbm_f, g).view(torch.int16)),
                  f"K1 on host rows != K1 on HBM at {L} x {n}")
            torch.cuda.synchronize()
        ms = device_ms(gather_rows_multi, [(host_f, g) for g in cold(n)],
                       ops_per_call=1)
        hbm_ms = device_ms(gather_rows_multi, [(hbm_f, g) for g in cold(n)],
                           ops_per_call=1)
        gids = [g.cpu() for g in cold(n)]
        t0 = time.perf_counter()
        for g in gids:
            gather_rows_multi_ref(host_f, g)
        plain = (time.perf_counter() - t0) * 1e3 / len(gids)
        staging = [torch.empty((L, n, hd), dtype=host[0].dtype,
                               pin_memory=True) for _ in gids]
        lib = call_ms(ref_route, list(zip(gids, staging)))
        with_launch = call_ms(gather_rows_multi,
                              [(host_f, g) for g in cold(n)])
        link_ms = L * n * row_bytes / PCIE5_X16_BYTES_PER_S * 1e3
        hbm_b_ms, _ = bound(L * (n * row_bytes + 8 * n), 0)
        b_ms, b_by = max((link_ms, "bytes over the host link at 64 GB/s"),
                         (hbm_b_ms, "bytes over HBM"))
        check(ms >= b_ms, f"K1 on host rows at {L} x {n}: {ms:.5f} ms is "
              f"below its bound {b_ms:.6f} ms: the timing is at fault")
        result[key] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                           library_ms=lib, bound_ms=b_ms, bound_by="bytes",
                           hbm_ms=hbm_ms, link_GBps=rate / 1e9)
        print(f"K1 host rows {L} tables x {n} rows ({what}, one launch) "
              f"[{smi}]: bit-equal to the plain version and to K1 on HBM; "
              f"device ms: kernel {ms:.5f} (from HBM {hbm_ms:.5f}), bound "
              f"{b_ms:.6f} ({b_by}: {L * n * row_bytes} B of rows; "
              f"the kernel at {100 * b_ms / ms:.1f} % of it; at the "
              f"measured {rate / 1e9:.2f} GB/s the rows take "
              f"{L * n * row_bytes / rate * 1e3:.6f}); per call with "
              f"launch: kernel {with_launch:.5f}; host ms: plain "
              f"version (CPU gather) {plain:.5f}, the reference's route "
              f"(CPU index_select into pinned memory + non_blocking copy) "
              f"{lib:.5f}")
        del staging
    return result


def serve_27b_once(cfg, params, dev, prompts, flags) -> tuple:
    """Phase 7's engine shapes and warm-up, its 8 prompts x 16 new tokens
    under ``flags``, counted from zero: (engine, launches, reads per step,
    run seconds, token streams, mean decode-wave ms)."""
    from repro_torch.serving import Engine
    eng = Engine(cfg, params=params, flags=flags, pool="CXL", max_batch=8,
                 max_len=512, prompt_bucket=32, device=dev)
    eng.warmup(prompts)
    rt = eng.runtime()
    eng.reset_stats()
    n_steps0 = len(eng._step_times)
    reset_launches()
    handles = [rt.submit(p, max_new=16) for p in prompts]
    pulls, run_s = drive(eng, rt)
    launches = read_launches()
    wave_ms = sum(eng._step_times[n_steps0:]) * 1e3 / eng.stats.decode_steps
    return eng, launches, pulls, run_s, [h.tokens for h in handles], wave_ms


def serve_host_27b(cfg, params, dev, smi: str, prompts, streams,
                   serve7: dict) -> tuple:
    """(a) and (b): phase 7's tables move into registered host buffers
    (``tables_to_host``, in place in phase 7's tree); K1 is held on the
    host rows (``check_k1_host``) while the HBM copies still exist, and a
    control run serves phase 7's mix from those HBM copies; then, the HBM
    copies freed, engram-27b serves phase 7's 8 prompts, 16 new tokens,
    with ``RunFlags(engram_strategy="pooled_host")`` and ``pool="CXL"``
    after the same warm-up. The streams must be phase 7's, K1 must launch
    once per decode wave and once per Engram layer per admission group,
    one read per steady wave and no other sync, and the peak device memory
    must drop by about the tables' 23 GB. The decode-wave wall time is
    printed beside the control's (same process state, just before) and
    phase 7's. Returns the launches of both runs, K1's host timings and
    the two host buffers."""
    import torch
    from repro_torch.models.params import tables_to_host
    from repro_torch.models.transformer import RunFlags

    host_facts(smi)
    layers = params["engram"]["layers"]
    hbm = [layer["tables"] for layer in layers]
    nbytes = sum(t.numel() * t.element_size() for t in hbm)
    t0 = time.perf_counter()
    tables_to_host(params)
    move_s = time.perf_counter() - t0
    host = [layer["tables"] for layer in layers]
    print(f"host run b: {nbytes / 1e9:.3f} GB of phase 7's tables moved to "
          f"host in {move_s:.2f} s (map, register and copy); "
          + host_status("now"))
    k1 = check_k1_host(cfg, hbm, host, dev, smi)
    ctrl = dict(params, engram={"layers": [dict(layer, tables=t) for
                                           layer, t in zip(layers, hbm)]})
    eng, ctrl_launches, _, _, got, ctrl_ms = serve_27b_once(
        cfg, ctrl, dev, prompts, RunFlags())
    check(got == streams, "host run b: the HBM control's streams differ "
          "from phase 7's")
    del eng, ctrl, hbm
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    eng, launches, pulls, run_s, got, wave_ms = serve_27b_once(
        cfg, params, dev, prompts, RunFlags(engram_strategy="pooled_host"))
    st = eng.stats
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(got == streams, f"host run b: streams {got} differ from phase "
          f"7's {streams}")
    k1_want = st.decode_steps + len(layers) * st.prefill_waves
    check(launches["engram_gather"] == k1_want,
          f"host run b: K1 launches {launches['engram_gather']} != "
          f"{st.decode_steps} decode waves + {len(layers)} x "
          f"{st.prefill_waves} admission groups")
    check(launches["gated_fuse"] == 2 * (st.prefill_waves + st.decode_steps),
          f"host run b: K2 launches {launches['gated_fuse']}")
    check(len(pulls) == st.decode_steps and all(p == 1 for p in pulls[1:]),
          f"host run b: device->host reads per step {pulls}")
    check(peak < serve7["peak_gb"] - 20,
          f"host run b: peak {peak:.2f} GB is not about 23 GB below phase "
          f"7's {serve7['peak_gb']:.2f} GB")
    print(f"host run b: engram-27b, pooled_host, pool=CXL, 8 requests x 16 "
          f"tokens: streams equal to phase 7's; {st.prefill_waves} "
          f"admission group(s), {st.decode_steps} decode waves; K1 launches "
          f"{launches['engram_gather']} (1 per decode wave + "
          f"{len(layers)} per admission group), K2 launches "
          f"{launches['gated_fuse']}; reads per step {pulls}; no other "
          f"sync")
    print(f"host run b [{smi}]: decode wave {wave_ms:.2f} ms (tables in "
          f"HBM: {ctrl_ms:.2f} ms in the control run just before, "
          f"{serve7['wave_ms']:.2f} ms in phase 7), peak device memory "
          f"{peak:.2f} GB (phase 7: {serve7['peak_gb']:.2f} GB), run "
          f"{run_s:.2f} s; " + host_status("host"))
    del eng
    for k in launches:
        launches[k] += ctrl_launches[k]
    return launches, k1, host


def check_host_rows(params, dev, label: str) -> None:
    """K1 on a model's own host tables against its plain version on the
    same bytes, bit-equal: one decode wave's ids (2 x 128), drawn over each
    table's whole row space, with the first and last rows, the last row of
    every sub-table and the rows either side of the byte offsets 2^31 to
    2^35 among them (engram-40b's tables hold 37 GB each: the kernel's
    offsets must not wrap at 32 bits). Synchronises after the call: a trap
    on a host row shows only at the next sync."""
    import torch
    from repro_torch.kernels.engram_gather import (gather_rows_multi,
                                                   gather_rows_multi_ref)
    tabs = [layer["tables"] for layer in params["engram"]["layers"]]
    T, V, hd = tabs[0].shape
    R, row_bytes = T * V, hd * tabs[0].element_size()
    edges = [0, R - 1] + [t * V + V - 1 for t in range(T)]
    for k in range(31, 36):
        r = (1 << k) // row_bytes
        edges += [x for x in (r - 1, r) if x < R]
    n = 16 * 8
    gen = torch.Generator(device=dev).manual_seed(15)
    gid = torch.randint(0, R, (len(tabs), n), generator=gen, device=dev)
    gid[:, :len(edges)] = torch.tensor(edges, device=dev)
    flats = [t.view(R, hd) for t in tabs]
    out = gather_rows_multi(flats, gid)
    torch.cuda.synchronize()
    check(torch.equal(out.cpu().view(torch.int16),
                      gather_rows_multi_ref(flats, gid.cpu())
                      .view(torch.int16)),
          f"{label}: K1 on the host tables not bit-equal to its plain "
          f"version")
    print(f"{label}: K1 on the model's host tables bit-equal to its plain "
          f"version at {len(tabs)} x {n} rows ({len(edges)} fixed: rows 0 "
          f"and {R - 1} (byte offset {(R - 1) * row_bytes}), the last row "
          f"of each of the {T} sub-tables, rows either side of 2^31 to "
          f"2^35 B)")


def record_waves(eng, keep: bool = True) -> list:
    """Wrap the engine's decode step so that each wave appends (logits,
    the slots' rids) to the returned list (``keep=False``: only the
    running max |logit|, a device scalar, as its one entry). Adds no
    sync."""
    import torch
    waves = []
    decode = eng._decode_ext_fn

    def recording(*args):
        logits, state = decode(*args)
        if keep:
            waves.append((logits, [r.rid if r is not None else None
                                   for r in eng.slots]))
        else:
            top = logits.abs().amax()
            waves[:] = [torch.maximum(waves[0], top) if waves else top]
        return logits, state
    eng._decode_ext_fn = recording
    return waves


def serve_host_model(cfg, dev, smi: str, host_tables=None,
                     max_new: int = 8, reps: int = 1, after=None,
                     profile_groups=None) -> tuple:
    """(c), (d) and (e) of phase 14, and phase 16: a model whose tables do
    not fit beside its weights on the card, at full width: K2 held at its
    d (T = 8 and 256) first, then the weights drawn on the card and the
    tables drawn on the card chunk by chunk into registered host buffers
    (``host_tables`` reused when given), then 8 prompts x ``max_new`` new
    tokens behind ``Engine(pool="CXL", max_batch=8, max_len=512)`` with
    pooled_host, ``reps`` counted runs after a warm-up, whose streams must
    be identical. K1 bit-equal on the model's host tables
    (``check_host_rows``), then K1 once per decode wave and once per
    Engram layer per admission group, K2 twice per wave and group, the
    grouped GEMM twice per MoE layer per wave and group (none without
    MoE), one read per steady wave and no other sync, tokens in the
    vocabulary, finite prefill logits (with a final softcap: every
    prefill and decode logit within it), peak device memory under 80 GB;
    then a profile of its steady decode waves (``profile_groups`` as in
    ``profile_waves``). ``after(eng, params)`` runs on the served engine
    before it is freed. Returns the launches of the counted runs, K2's
    timings, the host tables (for the next model of their shape) and
    what ``after`` returned."""
    import torch
    from repro_torch.kernels.engram_gather.host import host_empty
    from repro_torch.models import moe
    from repro_torch.models.model import init_params, model_defs
    from repro_torch.models.params import (DTYPES, table_memory_for,
                                           tree_leaves)
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import Engine

    e = cfg.engram
    label = f"host run {cfg.name}"
    flags = RunFlags(engram_strategy="pooled_host")
    n_moe = sum(f == "moe" for f in cfg.ffn_types)
    gen = torch.Generator(device=dev).manual_seed(3)
    k2 = {n_t: time_k2(gen, dev, n_t, cfg.d_model,
                       len(e.orders) * e.emb_dim) for n_t in (8, 256)}
    torch.cuda.reset_peak_memory_stats()
    reused = host_tables is not None
    t0 = time.perf_counter()
    if not reused:
        host_tables = [host_empty(d.shape, DTYPES[d.dtype]) for d in
                       (layer["tables"] for layer in
                        model_defs(cfg)["engram"]["layers"])]
    t1 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev,
                         table_memory=table_memory_for(cfg, flags),
                         host_tables=host_tables)
    reg_s, draw_s = t1 - t0, time.perf_counter() - t1
    host_tables = [layer["tables"] for layer in params["engram"]["layers"]]
    leaves = list(tree_leaves(params))
    on_card = sum(t.numel() for t in leaves if t.device.type == "cuda")
    on_host = sum(t.numel() * t.element_size() for t in leaves
                  if t.device.type == "cpu")
    print(f"{label}: {cfg.n_layers} layers d_model {cfg.d_model} vocab "
          f"{cfg.vocab_size} engram layers {cfg.engram_layers()}: "
          f"{on_card / 1e9:.3f} B parameters on the card, "
          f"{on_host / 1e9:.3f} GB of tables in host memory "
          f"({'reused buffers' if reused else 'new buffers'}): map and "
          f"register {reg_s:.2f} s, draw and fill {draw_s:.2f} s; "
          + host_status("now"))
    check_host_rows(params, dev, label)
    eng = Engine(cfg, params=params, flags=flags, pool="CXL", max_batch=8,
                 max_len=512, prompt_bucket=32, device=dev)
    del params, leaves
    prompts = serve_prompts(cfg)
    eng.warmup(prompts)
    rt = eng.runtime()
    cap = cfg.final_logit_softcap
    n_eng = len(cfg.engram_layers())
    launches = dict.fromkeys(read_launches(), 0)
    first = None
    top = record_waves(eng, keep=False)
    for rep in range(reps):
        eng.reset_stats()
        n_steps0 = len(eng._step_times)
        top.clear()
        reset_launches()
        moe.grouped_mm.launches = 0
        handles = [rt.submit(p, max_new=max_new) for p in prompts]
        pulls, run_s = drive(eng, rt)
        got = read_launches()
        gmm = moe.grouped_mm.launches
        st = eng.stats
        streams = [h.tokens for h in handles]
        first = first or streams
        check(all(h.finished and len(h.tokens) == max_new for h in handles)
              and all(0 <= t < cfg.vocab_size for s_ in streams
                      for t in s_),
              f"{label}: not every request emitted {max_new} tokens of the "
              f"vocabulary")
        check(streams == first, f"{label}: run {rep + 1}'s streams "
              f"{streams} differ from run 1's {first}")
        check(got["engram_gather"] == st.decode_steps
              + n_eng * st.prefill_waves,
              f"{label}: K1 launches {got['engram_gather']} != "
              f"{st.decode_steps} + {n_eng} x {st.prefill_waves}")
        check(got["gated_fuse"] == 2 * (st.prefill_waves + st.decode_steps),
              f"{label}: K2 launches {got['gated_fuse']}")
        check(gmm == 2 * n_moe * (st.prefill_waves + st.decode_steps),
              f"{label}: {gmm} grouped GEMMs != 2 x {n_moe} MoE layers x "
              f"({st.prefill_waves} groups + {st.decode_steps} waves)")
        check(len(pulls) == st.decode_steps
              and all(p == 1 for p in pulls[1:]),
              f"{label}: device->host reads per step {pulls}")
        if cap > 0:
            check(top[0].item() <= cap, f"{label}: a decode logit "
                  f"{top[0].item()} beyond the final softcap {cap}")
        for k in launches:
            launches[k] += got[k]
        decode_s = sum(eng._step_times[n_steps0:])
        tokens = st.generated_tokens - st.prefills
        print(f"{label} run {rep + 1}: pooled_host, pool=CXL, 8 requests x "
              f"{max_new} tokens, {st.prefill_waves} admission group(s), "
              f"{st.decode_steps} decode waves; K1 launches "
              f"{got['engram_gather']}, K2 launches {got['gated_fuse']}"
              + (f", grouped GEMMs {gmm}" if n_moe else "")
              + f"; reads per step {pulls}; no other sync"
              + (f"; streams equal to run 1's" if rep else ""))
        print(f"{label} run {rep + 1} [{smi}]: decode "
              f"{tokens / decode_s:.2f} tok/s, wave "
              f"{decode_s * 1e3 / st.decode_steps:.2f} ms, mean TTFT "
              f"{st.mean_ttft_s * 1e3:.2f} ms, run {run_s:.2f} s"
              + (f", max |decode logit| {top[0].item():.4f} (cap {cap})"
                 if cap > 0 else ""))
    toks = torch.zeros((len(prompts), 32), dtype=torch.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    logits, _ = eng._prefill_fn(eng.params, {
        "tokens": toks.to(dev), "lengths": torch.tensor(
            [len(p) for p in prompts], device=dev)})
    check(tuple(logits.shape) == (len(prompts), cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{label}: prefill logits not finite")
    if cap > 0:
        check(logits.abs().max().item() <= cap,
              f"{label}: a prefill logit beyond the final softcap {cap}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 80, f"{label}: peak device memory {peak:.2f} GB")
    prof = profile_waves(eng, rt, prompts, label=f"{label} profile",
                         groups=profile_groups)
    print(f"{label} [{smi}]: peak device memory {peak:.2f} GB; prefill "
          f"logits of the 8 prompts finite, max |logit| "
          f"{logits.abs().max().item():.4f}; first stream {first[0]}; "
          + host_status("host"))
    del rt, logits
    extra = after(eng, dict(streams=first, peak_gb=peak, profile=prof)) \
        if after else None
    del eng
    return launches, k2, host_tables, extra


# ---------------------------------------------------------------------------
# phase 15: gemma3-1b at full width, tables in HBM
# ---------------------------------------------------------------------------

def window_witness(runs: dict, ulps: int = 16) -> dict:
    """Hold ``decode_window_slice``'s decode waves (``runs[True]``) to the
    masked ones (``runs[False]``), row by row (a request's rid), up to the
    first wave whose argmax differs anywhere: each logit within ``ulps``
    bf16 ulps (2^-8 each) of its own size plus its row's RMS,
    ``|a - b| <= ulps * 2^-8 * (|a| + rms(row))``. The slice changes only
    the order of the attention sums, and its bf16 roundings pass through
    26 residual adds, so the hidden state moves by a few ulps and every
    logit by as many ulps of the row's RMS (7.7 of them at most on an
    H100 at full width); a slice of the wrong rows moves typical logits
    by about their RMS, 256 ulps. Where the streams part, the masked
    row's top-2 margin at that wave must be within the tolerance at its
    top logit (a near-tie that bf16 rounding may flip). Returns the largest difference, its largest
    share of its tolerance and the parting point (None when the streams
    agree)."""
    a, b = runs[False]["waves"], runs[True]["waves"]
    rel = ulps * 2.0 ** -8
    worst, share, parted = 0.0, 0.0, None
    for j, ((la, sa), (lb, sb)) in enumerate(zip(a, b)):
        rids = [r for r in sa if r is not None]
        rows_a = la[[sa.index(r) for r in rids]].float()
        rows_b = lb[[sb.index(r) for r in rids]].float()
        rms = rows_a.square().mean(dim=-1, keepdim=True).sqrt()
        tol = rel * (rows_a.abs() + rms)
        diff = (rows_a - rows_b).abs()
        worst = max(worst, diff.max().item())
        share = max(share, (diff / tol).max().item())
        check(bool((diff <= tol).all()), f"window slice: wave {j} logits "
              f"differ by up to {(diff / tol).max().item():.2f} x their "
              f"tolerance")
        flip = (rows_a.argmax(-1) != rows_b.argmax(-1)).nonzero().flatten()
        if len(flip):
            i = int(flip[0])
            top = rows_a[i].topk(2).values.tolist()
            tol_i = rel * (abs(top[0]) + rms[i].item())
            parted = dict(wave=j, rid=rids[i], margin=top[0] - top[1],
                          tol=tol_i)
            check(top[0] - top[1] <= tol_i, f"window slice: rid {rids[i]} "
                  f"parts at wave {j} with a top-2 margin "
                  f"{top[0] - top[1]:.4f} > {tol_i:.4f}: not a near-tie")
            break
    return dict(worst=worst, share=share, parted=parted)


def serve_gemma3(dev, smi: str) -> tuple:
    """gemma3-1b at full width and depth (26 layers, d 1152, a 512-token
    window on 22 local layers, qk-norms, two RoPE bases, tied and scaled
    embeddings), seeded bf16 weights and ENGRAM_27B tables drawn on the
    card, ``pool="CXL"``: (c) K2 at d = 1152 (T = 8, 256, 2112) against its
    plain version first; (a) one 2100-token prompt (bucket 2112) through
    monolithic admission at ``max_len=2176``, after a warm-up with another:
    chunked attention in every layer, whose local layers skip the KV block
    wholly before the window (counted), 8 new tokens, TTFT; (b) 8 prompts
    of 490 to 510 tokens, 32 new tokens each, decoding across position
    512, with ``decode_window_slice`` off and then on: the waves' logits
    held together and the streams compared (``window_witness``), and each
    run's steady waves profiled. Launch and read budgets as phase 7's in
    each run; peak device memory printed.
    Returns the launches of the counted runs and K2's timings."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.layers import with_f32_head
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import Engine

    cfg = get_config("gemma3-1b")
    e = cfg.engram
    gen = torch.Generator(device=dev).manual_seed(4)
    k2 = {n_t: time_k2(gen, dev, n_t, cfg.d_model,
                       len(e.orders) * e.emb_dim) for n_t in (8, 256, 2112)}
    torch.cuda.reset_peak_memory_stats()
    # one f32 head (the transposed tied embedding) for every engine here
    params = with_f32_head(draw_params(cfg, dev))
    launches = dict.fromkeys(read_launches(), 0)
    rng = np.random.RandomState(15)
    n_local = sum(k == "local" for k in cfg.attn_kinds)
    label = "gemma3-1b"

    def counted(eng, rt, prompts, max_new):
        eng.reset_stats()
        n0 = len(eng._step_times)
        reset_launches()
        handles = [rt.submit(p, max_new=max_new) for p in prompts]
        pulls, run_s = drive(eng, rt)
        got, st = read_launches(), eng.stats
        check(all(h.finished and len(h.tokens) == max_new for h in handles)
              and all(0 <= t < cfg.vocab_size for h in handles
                      for t in h.tokens),
              f"{label}: not every request emitted {max_new} tokens of the "
              f"vocabulary")
        check(got["engram_gather"] == st.decode_steps,
              f"{label}: K1 launches {got['engram_gather']} != one per "
              f"{st.decode_steps} decode waves")
        check(got["gated_fuse"] == 2 * (st.prefill_waves + st.decode_steps),
              f"{label}: K2 launches {got['gated_fuse']}")
        check(len(pulls) == st.decode_steps
              and all(p == 1 for p in pulls[1:]),
              f"{label}: device->host reads per step {pulls}")
        for k in launches:
            launches[k] += got[k]
        decode_s = sum(eng._step_times[n0:])
        return handles, dict(
            pulls=pulls, run_s=run_s, launches=got, waves=st.decode_steps,
            groups=st.prefill_waves, ttft_ms=st.mean_ttft_s * 1e3,
            wave_ms=decode_s * 1e3 / st.decode_steps,
            tok_s=(st.generated_tokens - st.prefills) / decode_s)

    # (a) a 2100-token prompt: chunked attention with the window's skip
    eng = Engine(cfg, params=params, pool="CXL", max_batch=8, max_len=2176,
                 prompt_bucket=32, device=dev)
    warm, prompt = (list(rng.randint(1, cfg.vocab_size, size=2100))
                    for _ in range(2))
    eng.warmup([warm])
    rt = eng.runtime()
    attention._chunk_attn.window_skipped = 0
    r = counted(eng, rt, [prompt], 8)[1]
    skipped = attention._chunk_attn.window_skipped
    fl = RunFlags()
    S = 2112
    want = n_local * sum(max(0, (i * fl.q_chunk - cfg.window_size)
                                // fl.kv_chunk)
                         for i in range(-(-S // fl.q_chunk)))
    check(skipped == want, f"{label} long prompt: {skipped} KV blocks "
          f"skipped by the window, want {want}")
    print(f"{label} long prompt: 2100 tokens (bucket {S}) + 8 new, "
          f"monolithic admission, chunked attention (q and kv chunks of "
          f"{fl.q_chunk}) in all {cfg.n_layers} layers; the window skipped "
          f"{skipped} KV blocks ({n_local} local layers x 1: q chunk 2 skips "
          f"block 0) of the {n_local * 6} causal ones on local layers; K1 "
          f"launches {r['launches']['engram_gather']}, K2 launches "
          f"{r['launches']['gated_fuse']}; reads per step {r['pulls']}; no "
          f"other sync")
    print(f"{label} long prompt [{smi}]: TTFT {r['ttft_ms']:.2f} ms, run "
          f"{r['run_s']:.3f} s")
    del eng, rt
    gc.collect()
    torch.cuda.empty_cache()

    # (b) across the window, decode_window_slice off and on
    prompts = [list(rng.randint(1, cfg.vocab_size, size=n))
               for n in (490, 493, 496, 499, 502, 505, 508, 510)]
    runs = {}
    for ws in (False, True):
        eng = Engine(cfg, params=params, flags=RunFlags(
            decode_window_slice=ws), pool="CXL", max_batch=8, max_len=576,
            prompt_bucket=32, device=dev)
        eng.warmup(prompts)
        rt = eng.runtime()
        waves = record_waves(eng)
        handles, r = counted(eng, rt, prompts, 32)
        runs[ws] = dict(r, waves=list(waves),
                        streams=[h.tokens for h in handles])
        del handles
        print(f"{label} window run (decode_window_slice={ws}): 8 prompts of "
              f"490 to 510 tokens x 32 new (positions 490 to 541), "
              f"{r['groups']} admission group(s), {r['waves']} decode waves;"
              f" K1 launches {r['launches']['engram_gather']}, K2 launches "
              f"{r['launches']['gated_fuse']}; reads per step {r['pulls']}; "
              f"no other sync")
        print(f"{label} window run (decode_window_slice={ws}) [{smi}]: "
              f"decode {r['tok_s']:.2f} tok/s, wave {r['wave_ms']:.2f} ms, "
              f"mean TTFT {r['ttft_ms']:.2f} ms, run {r['run_s']:.2f} s; "
              f"first stream {runs[ws]['streams'][0]}")
        profile_waves(eng, rt, prompts, max_new=6,
                      label=f"{label} profile (decode_window_slice={ws})")
        del eng, rt, waves
        gc.collect()
    w = window_witness(runs)
    same = runs[False]["streams"] == runs[True]["streams"]
    where = "" if w["parted"] is None else (
        f"; parted at wave {w['parted']['wave']} (rid {w['parted']['rid']})"
        f" with a top-2 margin {w['parted']['margin']:.6f} within the "
        f"tolerance {w['parted']['tol']:.4f}")
    check(same or w["parted"] is not None, f"{label}: streams differ with no "
          f"differing argmax in the recorded waves")
    print(f"{label} window runs [{smi}]: streams "
          f"{'identical' if same else 'differ'}; decode logits with and "
          f"without decode_window_slice differ by at most {w['worst']:.6f},"
          f" at most {w['share']:.3f} of the tolerance (16 bf16 ulps of "
          f"the logit plus its row's RMS){where}")
    del runs
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 80, f"{label}: peak device memory {peak:.2f} GB")
    print(f"{label} [{smi}]: peak device memory {peak:.2f} GB (weights, "
          f"f32 head, tables in HBM, KV and work)")
    del params
    return launches, k2


# ---------------------------------------------------------------------------
# phase 16: deepseek-v2-236b (MLA + MoE), 9 layers, tables on the host
# ---------------------------------------------------------------------------

def deepseek_v2_cut():
    """deepseek-v2-236b at full width cut to 9 layers: layer 0 dense (the
    config's one first dense layer), layers 1 to 8 MoE, ENGRAM_40B tables
    at layers (2, 4) (``engram_for(9, ENGRAM_40B)``)."""
    from repro_torch.configs import ENGRAM_40B, engram_for
    from repro_torch.configs.deepseek_v2_236b import full
    L = 9
    return dataclasses.replace(full(), n_layers=L, layer_types=("attn",) * L,
                               attn_kinds=("global",) * L,
                               ffn_types=("dense",) + ("moe",) * (L - 1),
                               engram=engram_for(L, ENGRAM_40B))


def moe_on_card(cfg, params, dev, smi: str) -> dict:
    """(c) Layer 1's MoE FFN at full width (160 experts top-6 and 2 shared
    of width 1536, d 5120) on bf16 inputs at T = 8 and 256, the grouped
    GEMM path against its plain per-expert loop (``grouped_mm_ref`` in
    ``grouped_mm``'s place) on the same inputs. Identical expert ids.
    Each of the layer's two grouped GEMMs, on the layer's own sorted rows,
    within chip_smoke's BF16_TOL scaled to its product (rtol 2^-7, atol
    1e-3 x max|product|): one rounding of an f32 sum each. The whole layer
    rounds to bf16 five times (both products, the activation, the
    weighted rows, the shared experts' sum), so its two paths part by a
    few ulps of the terms they sum; each is held to an f32 evaluation of
    the same function on the same bf16 weights and inputs (the per-expert
    loop in f32), and the grouped path's largest error must be within
    twice the plain loop's. Both paths' device times beside the layer's
    bound: the bytes of the experts the ids touch (gate+up and down), the
    shared experts, the router, the input and the output, over 3.35 TB/s.
    Also layer 1's absorbed MLA decode at batch 8 over a 512-position
    latent cache, device-timed. Returns the times."""
    import torch
    from repro_torch.models import mla, moe
    layer = params["segments"][0][1]
    p, m, d = layer["ffn"], cfg.moe, cfg.d_model
    check("w_gu" in p, "phase 16: layer 1 is not a MoE layer")
    print(f"deepseek-v2 moe: torch {torch.__version__} has "
          f"torch._grouped_mm: {hasattr(torch, '_grouped_mm')}")
    gen = torch.Generator(device=dev).manual_seed(16)
    dt = p["w_gu"].dtype
    f = m.d_ff_expert
    out = {}
    fn = lambda a: moe.moe_ffn(cfg, p, a)[0]              # noqa: E731

    def loop32(rows, w, offs):
        """The per-expert loop in f32, one expert's weights upcast at a
        time."""
        r = rows.new_zeros((rows.shape[0], w.shape[-1]), dtype=torch.float32)
        ends = offs.tolist()
        for g, (a, b) in enumerate(zip([0] + ends[:-1], ends)):
            if b > a:
                r[a:b] = rows[a:b].float() @ w[g].float()
        return r

    p32 = dict(p, shared={k: v.float() for k, v in p["shared"].items()})
    for T in (8, 256):
        xs = [(torch.randn(1, T, d, generator=gen, device=dev).to(dt),)
              for _ in range(4)]
        x = xs[0][0]
        eids = moe._route(m, p, x[0])[0]
        got = fn(x)
        # the layer's two products on its own sorted rows
        se, order = torch.sort(eids.reshape(-1), stable=True)
        offs = torch.searchsorted(se, torch.arange(1, m.n_experts + 1,
                                                   device=dev),
                                  out_int32=True)
        rows = x[0].index_select(0, order // m.top_k)
        act = moe._act(moe.grouped_mm(rows, p["w_gu"], offs)[:, :f],
                       cfg.ffn_act)
        gemm_err = 0.0
        for a, w in ((rows, p["w_gu"]), (act, p["w_down"])):
            g_out = moe.grouped_mm(a, w, offs).float()
            l_out = moe.grouped_mm_ref(a, w, offs).float()
            torch.testing.assert_close(
                g_out, l_out, rtol=BF16_TOL["rtol"],
                atol=BF16_TOL["atol"] * l_out.abs().max().item())
            gemm_err = max(gemm_err, (g_out - l_out).abs().max().item())
        grouped = moe.grouped_mm
        moe.grouped_mm = moe.grouped_mm_ref
        try:
            eids_plain = moe._route(m, p, x[0])[0]
            want = fn(x)
            plain_ms = device_ms(fn, xs, warmup=1)
            moe.grouped_mm = loop32
            exact = moe.moe_ffn(cfg, p32, x.float())[0]
        finally:
            moe.grouped_mm = grouped
        check(torch.equal(eids, eids_plain), f"moe T={T}: expert ids differ")
        err = (got.float() - exact).abs().max().item()
        err_plain = (want.float() - exact).abs().max().item()
        check(err <= 2 * err_plain, f"moe T={T}: the grouped path is "
              f"{err:.4e} from the f32 evaluation, the plain loop "
              f"{err_plain:.4e}")
        ms = device_ms(fn, xs, warmup=1)
        touched = sum(int(torch.unique(moe._route(m, p, a[0])[0]).numel())
                      for (a,) in xs) / len(xs)
        per_expert = 3 * d * f * 2
        nbytes = (touched * per_expert + m.n_shared * per_expert
                  + d * m.n_experts * 4 + 2 * T * d * 2)
        flops = 2 * T * (m.top_k + m.n_shared) * 3 * d * f \
            + 2 * T * d * m.n_experts
        b_ms, b_by = bound(nbytes, flops)
        out[T] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, max_abs_err=gemm_err, touched=touched,
                      layer_err=err, layer_err_plain=err_plain)
        print(f"deepseek-v2 moe T={T} [{smi}]: expert ids identical; each "
              f"grouped GEMM within BF16_TOL x max|product| of its plain "
              f"loop (max|diff| {gemm_err:.4e}); the layer: max|out| "
              f"{exact.abs().max().item():.4f}, grouped path {err:.4e} and "
              f"plain loop {err_plain:.4e} from the f32 evaluation, paths "
              f"{(got.float() - want.float()).abs().max().item():.4e} "
              f"apart; device ms: grouped {ms:.5f}, plain loop "
              f"{plain_ms:.5f}, bound {b_ms:.5f} ({b_by}: {touched:.1f} of "
              f"{m.n_experts} experts touched, {nbytes / 1e9:.3f} GB; "
              f"{100 * b_ms / ms:.1f} % of bound)")
    B, S = 8, 512
    cache = {"c_kv": torch.randn(B, S, cfg.mla.kv_lora_rank, generator=gen,
                                 device=dev).to(dt),
             "k_rope": torch.randn(B, S, cfg.mla.qk_rope_head_dim,
                                   generator=gen, device=dev).to(dt)}
    pos = torch.full((B,), S - 1, dtype=torch.long, device=dev)
    hs = [(torch.randn(B, 1, d, generator=gen, device=dev).to(dt),)
          for _ in range(4)]
    out["mla_ms"] = device_ms(
        lambda h: mla.mla_decode(cfg, layer["mixer"], h, cache, pos)[0], hs,
        warmup=1)
    n_moe = sum(f == "moe" for f in cfg.ffn_types)
    print(f"deepseek-v2 layers [{smi}]: absorbed MLA decode, batch 8 over "
          f"{S} latent positions: {out['mla_ms']:.5f} device ms a layer, "
          f"{cfg.n_layers * out['mla_ms']:.4f} a wave of {cfg.n_layers}; MoE "
          f"at T = 8: {out[8]['ms']:.5f} a layer, "
          f"{n_moe * out[8]['ms']:.4f} a wave of {n_moe}")
    return out


def mla_paths_agree(cfg, params, flags, dev, smi: str, n: int = 12) -> dict:
    """(d) MLA's absorbed decode against its decompressed prefill at full
    width, on each layer's own weights and the same bf16 inputs (two rows
    of 20 + ``n`` positions, RMS 1 as the block's normed input): the
    first 20 positions prefilled (their latents padded to 64 positions),
    then ``n`` absorbed decode steps, each output against one
    decompressed pass over all positions at the same position, within 16
    bf16 ulps of the output plus its row's RMS, ``|a - b| <= 16 * 2^-8 *
    (|b| + rms(row))`` (``window_witness``'s tolerance), on layers 0 and
    1. Layers the reference stacks draw their weights at
    1/sqrt(n_periods) (its fan-in rule), so their attention scores have
    an RMS in the hundreds:
    the softmax picks one key, and a bf16 rounding in either path flips
    near-tied keys. Layer 4's (periods of 5) difference and both layers'
    score RMS are printed beside the held layers', not held; so is what
    that does to the whole model: the last prompt position's logits of a
    20-token prefill against a 32-token one (the same decompressed path,
    other row counts). Returns the largest share of the tolerance per
    layer."""
    import math as _m
    import torch
    from repro_torch.models.layers import head_logits
    from repro_torch.models.mla import _latents, mla_attention, mla_decode
    from repro_torch.models.model import build_prefill_step, forward, pad_kv
    P, rel, res = 20, 16 * 2.0 ** -8, {}
    gen = torch.Generator(device=dev).manual_seed(16)
    for li, (si, j), held in ((0, (0, 0), True), (1, (0, 1), True),
                              (4, (2, 0), False)):
        p = params["segments"][si][j]["mixer"]
        h = torch.randn(2, P + n, cfg.d_model, generator=gen,
                        device=dev).to(p["wo"].dtype)
        pos = torch.arange(P + n, device=dev)
        full, _ = mla_attention(cfg, p, h, pos)
        _, cache = mla_attention(cfg, p, h[:, :P], pos[:P])
        cache = {k: pad_kv(v, 64) for k, v in cache.items()}
        share, worst = 0.0, 0.0
        for t in range(P, P + n):
            out, cache = mla_decode(cfg, p, h[:, t:t + 1], cache,
                                    torch.full((2,), t, device=dev))
            b = full[:, t].float()
            rms = b.square().mean(dim=-1, keepdim=True).sqrt()
            diff = (out[:, 0].float() - b).abs()
            share = max(share, (diff / (rel * (b.abs() + rms))).max().item())
            worst = max(worst, diff.max().item())
        q_nope, q_rope, c_kv, k_rope = _latents(cfg, p, h, pos)
        m = cfg.mla
        k = torch.cat([(c_kv @ p["wuk"]).view(2, P + n, cfg.n_heads,
                                              m.qk_nope_head_dim),
                       k_rope.expand(-1, -1, cfg.n_heads, -1)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            / _m.sqrt(q.shape[-1])
        srms = scores.square().mean().sqrt().item()
        res[li] = share
        if held:
            check(share <= 1.0, f"MLA paths, layer {li}: outputs differ by "
                  f"up to {share:.2f} x the tolerance")
        print(f"deepseek-v2 MLA paths, layer {li} [{smi}]: 2 rows, {P} "
              f"prefilled + {n} absorbed decode steps against one "
              f"decompressed pass: max|diff| {worst:.4e}, {share:.3f} of "
              f"the tolerance (16 bf16 ulps of |out| + row RMS; "
              f"{'held' if held else 'not held: stacked weights'}); "
              f"attention score RMS {srms:.2f}")
    toks = torch.randint(1, cfg.vocab_size, (2, P + n), generator=gen,
                         device=dev)
    h, _ = forward(cfg, flags, params, {"tokens": toks}, "prefill")
    b = head_logits(params["head"], h[:, P - 1]).float()
    a = build_prefill_step(cfg, flags)(params, {"tokens": toks[:, :P]})[0]
    rms = b.square().mean(dim=-1, keepdim=True).sqrt()
    model = ((a.float() - b).abs() / (rel * (b.abs() + rms))).max().item()
    print(f"deepseek-v2 model [{smi}]: position {P - 1}'s logits from a "
          f"{P}-token prefill and from a {P + n}-token one differ by up to "
          f"{model:.2f} x that tolerance (max |logit| "
          f"{b.abs().max().item():.2f}); not held")
    res["model"] = model
    return res


def serve_deepseek_v2(dev, smi: str, host_tables) -> tuple:
    """deepseek-v2-236b at full width (d 5120, 128 heads, MLA ranks 1536 and
    512, 160 routed experts top-6 and 2 shared of width 1536, a 102,400-word
    vocabulary), cut to 9 layers (``deepseek_v2_cut``): 33.24 B parameters
    drawn on the card, its ENGRAM_40B tables drawn into ``host_tables``
    (engram-40b's registered buffers, the same shapes), pooled_host.
    (a), (b) through ``serve_host_model``: K2 at d = 5120, K1 bit-equal on
    the host tables, peak under 80 GB, phase 7's mix with 16 new tokens
    twice after a warm-up (identical streams; K1, K2 and grouped-GEMM
    budgets; one read per steady wave, no other sync), a profile with
    the grouped GEMMs and the routing kernels listed; then (c)
    ``moe_on_card``, (d) ``mla_paths_agree`` and (e) one 2100-token prompt
    through monolithic admission at ``max_len=4096`` (MLA prefill through
    ``_chunk_attn``, Dk 192 and Dv 128). Returns the counted launches,
    K2's timings and (c)'s."""
    from repro_torch.models.transformer import RunFlags
    cfg = deepseek_v2_cut()
    groups = {"grouped GEMMs (torch._grouped_mm)":
              lambda n: "GroupProblemShape" in n or "grouped" in n.lower(),
              "MoE routing (sort, top-k, searchsorted)":
              lambda n: any(k in n.lower() for k in ("sort", "topk",
                                                     "searchsorted"))}

    def after(eng, served):
        moe = moe_on_card(cfg, eng.params, dev, smi)
        mla = mla_paths_agree(cfg, eng.params, eng.flags, dev, smi)
        long = serve_long_prompt(cfg, eng.params, dev, smi,
                                 flags=RunFlags(engram_strategy="pooled_host"),
                                 label="deepseek-v2 long prompt")
        return dict(moe=moe, mla=mla, long=long)

    launches, k2, _, extra = serve_host_model(
        cfg, dev, smi, host_tables, max_new=16, reps=2, after=after,
        profile_groups=groups)
    for k in launches:
        launches[k] += extra["long"][k]
    return launches, k2, extra["moe"]


# ---------------------------------------------------------------------------
# phases 17-18: the recurrent mixers (Mamba, mLSTM, sLSTM) at full width
# ---------------------------------------------------------------------------

ULPS16 = 16 * 2.0 ** -8


def ulps_share(got, want) -> float:
    """The largest share of the tolerance ``16 bf16 ulps of |want| plus
    its row's RMS`` (``window_witness``'s and ``mla_paths_agree``'s) that
    ``|got - want|`` reaches; rows along the last axis."""
    b = want.float()
    rms = b.square().mean(dim=-1, keepdim=True).sqrt()
    return ((got.float() - b).abs() / (ULPS16 * (b.abs() + rms))).max() \
        .item()


def jamba_cut():
    """jamba-1.5-large-398b at full width cut to 7 layers: mamba, mamba,
    mamba, attn, mamba, mamba, mamba (the config's first 7: attention at
    offset 3 of its period of 8), FFNs dense, moe, dense, moe, dense, moe,
    dense, ENGRAM_40B tables at (2, 3) (``engram_for(7, ENGRAM_40B)``).
    No segment has a periodic tail, so no layer is stacked."""
    from repro_torch.configs import ENGRAM_40B, engram_for
    from repro_torch.configs.jamba_1_5_large_398b import full
    cfg, L = full(), 7
    return dataclasses.replace(cfg, n_layers=L,
                               layer_types=cfg.layer_types[:L],
                               attn_kinds=cfg.attn_kinds[:L],
                               ffn_types=cfg.ffn_types[:L],
                               engram=engram_for(L, ENGRAM_40B))


def time_k1_tables(tables, dev, smi: str, label: str) -> dict:
    """K1 on a model's own tables (HBM, or registered host buffers) at a
    decode wave's ids (L tables x 16 x 8 rows, one launch) against its
    plain version, bit-equal, then timed (CUPTI, cold ids) beside its
    plain version and the library's route: on the card the plain version
    and one ``index_select`` per layer; from host rows the CPU gather and
    the reference's route (CPU ``index_select`` into pinned memory, then a
    ``non_blocking`` copy), on the host clock. Bound: the rows' bytes over
    HBM, or over PCIe Gen5 x16's nominal 64 GB/s from the host."""
    import torch
    from repro_torch.kernels.engram_gather import (gather_rows_multi,
                                                   gather_rows_multi_ref)
    L = len(tables)
    T, V, hd = tables[0].shape
    flats = [t.view(T * V, hd) for t in tables]
    row_bytes = hd * tables[0].element_size()
    host = tables[0].device.type == "cpu"
    n = 16 * 8
    gen = torch.Generator(device=dev).manual_seed(17)
    cold = [torch.randint(0, T * V, (L, n), generator=gen, device=dev)
            for _ in range(40)]
    for g in cold[:4]:
        out = gather_rows_multi(flats, g)
        torch.cuda.synchronize()
        ref = gather_rows_multi_ref(flats, g.cpu() if host else g)
        check(torch.equal(out.cpu().view(torch.int16),
                          ref.cpu().view(torch.int16)),
              f"{label}: K1 not bit-equal at {L} x {n} rows of {row_bytes} B")
    ms = device_ms(gather_rows_multi, [(flats, g) for g in cold],
                   ops_per_call=1)
    hbm_b_ms, _ = bound(L * (2 * n * row_bytes + 8 * n), 0)
    if host:
        gids = [g.cpu() for g in cold]
        t0 = time.perf_counter()
        for g in gids:
            gather_rows_multi_ref(flats, g)
        plain = (time.perf_counter() - t0) * 1e3 / len(gids)
        staging = [torch.empty((L, n, hd), dtype=tables[0].dtype,
                               pin_memory=True) for _ in gids]

        def route(g_cpu, out):
            for j in range(L):
                torch.index_select(flats[j], 0, g_cpu[j], out=out[j])
            return out.to(dev, non_blocking=True)
        lib = call_ms(route, list(zip(gids, staging)))
        b_ms = max(L * n * row_bytes / PCIE5_X16_BYTES_PER_S * 1e3, hbm_b_ms)
        how = "host ms: CPU gather, the reference's route"
    else:
        plain = device_ms(gather_rows_multi_ref, [(flats, g) for g in cold])
        lib = device_ms(lambda g: [torch.index_select(t, 0, r)
                                   for t, r in zip(flats, g)],
                        [(g,) for g in cold], ops_per_call=L)
        b_ms = hbm_b_ms
        how = f"device ms: plain, {L} index_selects"
    check(ms >= b_ms, f"{label}: K1 {ms:.5f} ms below its bound {b_ms:.6f}")
    print(f"{label} K1 [{smi}]: {L} tables x {n} rows x {row_bytes} B "
          f"({'host' if host else 'HBM'} tables, one launch): bit-equal; "
          f"device ms kernel {ms:.5f}, bound {b_ms:.6f} (bytes); {how} "
          f"{plain:.5f}, {lib:.5f}")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by="bytes")


def recurrent_layer(cfg, p, kind: str, dev, smi: str, label: str) -> dict:
    """One recurrent layer (``kind``: mamba, mlstm or slstm) on its own
    bf16 weights ``p`` at full width, inputs of RMS 1 as the block's
    normed input: (i) after a 16-token prefill at B = 8, a decode step
    against an f32 evaluation of the same function on the same bf16
    weights, input and state, upcast, within 16 bf16 ulps of |out| plus
    its row's RMS, or within twice the error of the same bf16 step on the
    CPU (PyTorch's CPU kernels) where that is larger: the bf16 roundings
    of the state's read-out terms before their sum, which cancels, make
    a Mamba step's error exceed 16 ulps on some inputs (1.14 times the
    tolerance on an H100 at jamba's full width); (ii) a 32-token prefill
    at B = 8 against 32 decode steps from zero state, the last
    position's output, within 16 bf16 ulps of |out| plus its row's RMS.
    Then device times (CUPTI): the decode step at B = 8 beside its byte
    bound (the layer's weights, its state read and written, the token in
    and out) and a 256-token prefill at B = 1, with that prefill's
    host-clock time (the per-step scan launches several operations per
    token). Returns the numbers."""
    import torch
    from repro_torch.models import mamba, xlstm
    from repro_torch.models.params import tree_leaves, tree_map
    fwd = {"mamba": mamba.mamba_forward, "mlstm": xlstm.mlstm_forward,
           "slstm": xlstm.slstm_forward}[kind]
    dt = next(t for t in tree_leaves(p) if t.dim() == 2).dtype

    def zero(B):
        if kind == "mamba":
            return mamba.init_mamba_cache(cfg, B, dt, dev)
        return xlstm.init_xlstm_cache(cfg, kind, B, dt, dev)

    gen = torch.Generator(device=dev).manual_seed(18)
    rnd = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                 device=dev).to(dt)
    x = rnd(8, 17, cfg.d_model)
    _, cache = fwd(cfg, p, x[:, :16])
    got, _ = fwd(cfg, p, x[:, 16:], cache)
    want, _ = fwd(cfg, tree_map(lambda t: t.float(), p), x[:, 16:].float(),
                  {k: v.float() for k, v in cache.items()})
    dec = ulps_share(got[:, 0], want[:, 0])
    cpu = lambda t: t.to("cpu")                          # noqa: E731
    on_cpu, _ = fwd(cfg, tree_map(cpu, p), cpu(x[:, 16:]),
                    {k: cpu(v) for k, v in cache.items()})
    dec_cpu = ulps_share(on_cpu[:, 0], cpu(want[:, 0]))
    check(dec <= max(1.0, 2 * dec_cpu), f"{label}: decode step against "
          f"f32: {dec:.2f} x the tolerance, the CPU's bf16 {dec_cpu:.2f}")
    x = rnd(8, 32, cfg.d_model)
    full, _ = fwd(cfg, p, x)
    c = zero(8)
    for t in range(32):
        out, c = fwd(cfg, p, x[:, t:t + 1], c)
    pre = ulps_share(out[:, 0], full[:, -1])
    check(pre <= 1.0, f"{label}: 32 decode steps against a 32-token "
          f"prefill: {pre:.2f} x the tolerance")
    wbytes = sum(t.numel() * t.element_size() for t in tree_leaves(p))
    sbytes = sum(t.numel() * t.element_size() for t in cache.values())
    nbytes = wbytes + 2 * sbytes + 2 * 8 * cfg.d_model * 2
    b_ms, b_by = bound(nbytes, 2 * 8 * wbytes / 2)
    args = [(rnd(8, 1, cfg.d_model), cache) for _ in range(4)]
    ms = device_ms(lambda a, c_: fwd(cfg, p, a, c_), args, warmup=1)
    xs = [(rnd(1, 256, cfg.d_model),) for _ in range(2)]
    pf_ms = device_ms(lambda a: fwd(cfg, p, a), xs, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd(cfg, p, xs[0][0])
    torch.cuda.synchronize()
    pf_wall = (time.perf_counter() - t0) * 1e3
    print(f"{label} [{smi}]: decode step at B=8 against an f32 evaluation "
          f"of the same bf16 weights {dec:.3f} of the tolerance (the same "
          f"step in bf16 on the CPU {dec_cpu:.3f}), 32 decode "
          f"steps against a 32-token prefill {pre:.3f} (16 bf16 ulps of "
          f"|out| + row RMS); decode step device {ms:.5f} ms, bound "
          f"{b_ms:.5f} ({b_by}: {wbytes / 1e9:.3f} GB of weights, "
          f"{sbytes / 1e6:.2f} MB of state read and written; "
          f"{100 * b_ms / ms:.1f} % of bound); 256-token prefill at B=1: "
          f"device {pf_ms:.3f} ms, host clock {pf_wall:.2f} ms")
    return dict(dec_share=dec, dec_share_cpu=dec_cpu, pre_share=pre, ms=ms,
                bound_ms=b_ms,
                prefill_ms=pf_ms, prefill_wall_ms=pf_wall)


def chunked_vs_monolithic(cfg, params, flags, dev, smi: str, label: str,
                          C: int = 16) -> dict:
    """(d) Chunked admission (``prefill_chunk=C``) against monolithic on
    one prompt of exactly 32 tokens (no pad: the bucket is 32): the
    first-token logits of two chunk steps against one prefill, within 16
    bf16 ulps of |logit| + row RMS; then each engine serves the prompt,
    16 new tokens, and where the streams part is printed with the
    monolithic engine's top-2 margin there."""
    import numpy as np
    import torch
    from repro_torch.models.model import (build_chunk_prefill,
                                          build_prefill_step,
                                          init_decode_state)
    from repro_torch.serving import Engine
    toks = torch.from_numpy(np.random.RandomState(17).randint(
        1, cfg.vocab_size, size=(1, 32))).to(dev)
    mono = build_prefill_step(cfg, flags)(params, {"tokens": toks})[0]
    state = init_decode_state(cfg, flags, 1, 64, dev)
    step = build_chunk_prefill(cfg, flags)
    for i in range(0, 32, C):
        chunked, state = step(params, state, toks[:, i:i + C],
                              torch.full((1,), C, device=dev))
    share = ulps_share(chunked, mono)
    check(share <= 1.0, f"{label}: chunked first-token logits "
          f"{share:.2f} x the tolerance from the monolithic")
    streams, waves = [], []
    for kw in ({}, dict(prefill_chunk=C)):
        eng = Engine(cfg, params=params, flags=flags, pool="CXL",
                     max_batch=1, max_len=64, prompt_bucket=32, device=dev,
                     **kw)
        got = record_waves(eng)
        rid = eng.submit(toks[0].tolist(), max_new=16)
        eng.run()
        streams.append(eng.done[rid].out)
        waves.append([lg[0] for lg, _ in got])
        del eng
    a, b = streams
    part = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    where = "identical"
    if part is not None:
        # wave j emits token j + 1 (token 0 comes from the prefill)
        top = (waves[0][part - 1] if part else mono[0]).float().topk(2)
        where = (f"part at token {part} ({a[part]} against {b[part]}); "
                 f"the monolithic top-2 margin there "
                 f"{(top.values[0] - top.values[1]).item():.4f}")
    print(f"{label} [{smi}]: a 32-token prompt, chunks of {C} against one "
          f"prefill: first-token logits {share:.3f} of the tolerance (16 "
          f"bf16 ulps of |logit| + row RMS); 16-token streams {where}")
    return dict(share=share, part=part)


def serve_jamba(dev, smi: str, host_tables) -> tuple:
    """jamba-1.5-large-398b at full width (d 8192, Mamba d_inner 16384
    with 16 states, 64 query and 8 KV heads, 16 experts top-2 of width
    24576, a 65,536-word vocabulary) cut to 7 layers (``jamba_cut``):
    70.67 GB of weights drawn on the card, its ENGRAM_40B tables drawn
    into ``host_tables`` (engram-40b's registered buffers), pooled_host.
    (a), (b) through ``serve_host_model``: K2 at d = 8192, K1 bit-equal on
    the host tables, peak under 80 GB, phase 7's mix with 16 new tokens
    twice after a warm-up (identical streams; K1, K2 and grouped-GEMM
    budgets; one read per steady wave, no other sync), a profile; then
    K1 timed on the host tables, (c) ``recurrent_layer`` on layer 0 with
    the Mamba layers' share of a wave's device time (6 decode steps over
    the profile's wave), (d) ``chunked_vs_monolithic`` and (e) one
    2100-token prompt at ``max_len=4096`` after a 32-token warm-up, with
    the share of its TTFT that 6 selective scans over 2112 positions take
    on the host clock. Returns the counted launches, K2's timings and the
    rest."""
    import torch
    from repro_torch.models import mamba
    from repro_torch.models.transformer import RunFlags
    cfg = jamba_cut()
    flags = RunFlags(engram_strategy="pooled_host")
    n_mamba = cfg.layer_types.count("mamba")

    def after(eng, served):
        p = eng.params
        tables = [layer["tables"] for layer in p["engram"]["layers"]]
        k1 = time_k1_tables(tables, dev, smi, "jamba")
        layer = recurrent_layer(cfg, p["segments"][0][0]["mixer"], "mamba",
                                dev, smi, "jamba mamba layer 0")
        share = n_mamba * layer["ms"] / served["profile"]["dev_ms"]
        print(f"jamba [{smi}]: {n_mamba} Mamba decode steps take "
              f"{n_mamba * layer['ms']:.4f} device ms of a wave's "
              f"{served['profile']['dev_ms']:.4f} ({100 * share:.1f} %)")
        agree = chunked_vs_monolithic(cfg, p, flags, dev, smi,
                                      "jamba chunked")
        info = {}
        long = serve_long_prompt(cfg, p, dev, smi, flags=flags,
                                 label="jamba long prompt", warm_n=32,
                                 info=info)
        mp = p["segments"][0][0]["mixer"]
        di, N = cfg.mamba.d_inner(cfg.d_model), cfg.mamba.d_state
        gen = torch.Generator(device=dev).manual_seed(19)
        ins = [torch.randn(1, 2112, k, generator=gen, device=dev)
               .to(mp["in_proj"].dtype) for k in (di, di, N, N)]
        A = -torch.exp(mp["A_log"])
        h = torch.zeros((1, di, N), device=dev)
        mamba.selective_scan(h, *[t[:, :8] for t in ins], A)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mamba.selective_scan(h, *ins, A)
        torch.cuda.synchronize()
        scan_ms = (time.perf_counter() - t0) * 1e3
        print(f"jamba long prompt [{smi}]: one selective scan over 2112 "
              f"positions {scan_ms:.1f} ms on the host clock; {n_mamba} of "
              f"them {n_mamba * scan_ms:.1f} ms, "
              f"{100 * n_mamba * scan_ms / info['ttft_ms']:.1f} % of the "
              f"TTFT {info['ttft_ms']:.1f} ms")
        return dict(k1=k1, layer=layer, share=share, agree=agree, long=long,
                    scan_ms=scan_ms, ttft_ms=info["ttft_ms"])

    launches, k2, _, extra = serve_host_model(
        cfg, dev, smi, host_tables, max_new=16, reps=2, after=after)
    for k in launches:
        launches[k] += extra["long"][k]
    return launches, k2, extra


def serve_xlstm(dev, smi: str) -> tuple:
    """xlstm-125m at full width and depth (12 layers, d 768, 4 heads,
    mLSTM with d_inner 1536 and sLSTM at layer 7, no FFN, a tied head),
    seeded bf16 weights and its ENGRAM_27B-vocabulary tables (rows of 96
    bf16, 13.92 GB) drawn on the card, ``pool="CXL"``: K2 at d = 768 (T =
    8, 256) first; K1 on its tables, bit-equal and timed at 192-byte rows;
    serve's mix (phase 7's 8 prompts, 16 new tokens) twice after a
    warm-up, identical streams, every decode logit finite, phase 7's
    launch and read budgets, then a profile; the unstacked mLSTM layer 6
    and the sLSTM layer 7 through ``recurrent_layer``, with the xLSTM
    layers' share of a wave's device time; ``chunked_vs_monolithic``; a
    512-token prompt's TTFT. Returns the counted launches, K1's and K2's
    timings and the rest."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import with_f32_head
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import Engine
    cfg = get_config("xlstm-125m")
    e, label = cfg.engram, "xlstm-125m"
    gen = torch.Generator(device=dev).manual_seed(5)
    k2 = {n_t: time_k2(gen, dev, n_t, cfg.d_model,
                       len(e.orders) * e.emb_dim) for n_t in (8, 256)}
    torch.cuda.reset_peak_memory_stats()
    params = with_f32_head(draw_params(cfg, dev))
    k1 = time_k1_tables([layer["tables"] for layer in
                         params["engram"]["layers"]], dev, smi, label)
    eng = Engine(cfg, params=params, pool="CXL", max_batch=8, max_len=512,
                 prompt_bucket=32, device=dev)
    prompts = serve_prompts(cfg)
    eng.warmup(prompts)
    rt = eng.runtime()
    top = record_waves(eng, keep=False)
    launches = dict.fromkeys(read_launches(), 0)
    first = None
    for rep in range(2):
        top.clear()
        got, streams, summary = serve_once(cfg, eng, rt, prompts, dev, smi,
                                           rep)
        first = first or streams
        check(streams == first, f"{label}: run {rep + 1}'s streams differ "
              f"from run 1's")
        check(bool(torch.isfinite(top[0])), f"{label}: a decode logit is "
              f"not finite")
        for k in launches:
            launches[k] += got[k]
    prof = profile_waves(eng, rt, prompts, label=f"{label} profile")
    del eng, rt
    mixers = [params["segments"][2][j]["mixer"] for j in (0, 1)]
    layers = {kind: recurrent_layer(cfg, m, kind, dev, smi,
                                    f"{label} {kind} layer {6 + j}")
              for j, (kind, m) in enumerate(zip(("mlstm", "slstm"),
                                                mixers))}
    steps = sum(layers[t]["ms"] for t in cfg.layer_types)
    print(f"{label} [{smi}]: {cfg.n_layers} xLSTM decode steps (layer 6's "
          f"time for each mLSTM) take {steps:.4f} device ms of a wave's "
          f"{prof['dev_ms']:.4f} ({100 * steps / prof['dev_ms']:.1f} %); "
          f"streams of both runs identical, first {first[0]}")
    agree = chunked_vs_monolithic(cfg, params, RunFlags(), dev, smi,
                                  f"{label} chunked")
    info = {}
    long = serve_long_prompt(cfg, params, dev, smi, label=f"{label} prompt",
                             n=512, info=info)
    for k in launches:
        launches[k] += long[k]
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 80, f"{label}: peak device memory {peak:.2f} GB")
    print(f"{label} [{smi}]: peak device memory {peak:.2f} GB (weights, f32 "
          f"head, tables in HBM, state and work)")
    del params
    return launches, k1, k2, dict(layers=layers, agree=agree,
                                  profile=prof, ttft_ms=info["ttft_ms"],
                                  wave_ms=summary["wave_ms"])


# ---------------------------------------------------------------------------
# phases 19-21: the encoder, the vision stub and the serving CLI
# ---------------------------------------------------------------------------

# a whole stack's bf16 logits against an f32 evaluation (or the chunked
# encoder against the dense one), as a share of the largest logit: bf16
# rounding through the layers moves them by a few percent of it at unit
# gain (0.0147 to 0.0366 in phases 19 and 20 on an H100 80GB HBM3 at 700
# W); phase 19 plants a wrong mask at full width and requires each to read
# above it (on that card: the pad keys let into the softmax 0.3450, a
# causal mask 1.2605)
STACK_TOL = 0.1


@contextlib.contextmanager
def planted_mask(fault: str):
    """A wrong mask in ``_chunk_attn`` inside this block, for phase 19 to
    show that ``STACK_TOL`` sees it: ``"causal"`` runs the encoder's
    chunked attention causal; ``"pad keys"`` pads keys and queries to
    whole KV chunks before the call, the keys at a position the validity
    mask takes for real, so the last chunk's zero keys enter the softmax
    (the reference's F12)."""
    import torch
    from repro_torch.models import attention
    sound = attention._chunk_attn

    def planted(cfg, q, k, v, qpos, kpos, *, causal=True, kv_chunk=1024,
                **kw):
        if fault == "causal":
            return sound(cfg, q, k, v, qpos, kpos, causal=True,
                         kv_chunk=kv_chunk, **kw)
        S = q.shape[1]
        pad = -(-S // kv_chunk) * kv_chunk - S
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
        qpos = torch.cat([qpos, qpos.new_full((pad,), -1)])
        kpos = torch.cat([kpos, kpos.new_full((pad,), 2 ** 29)])
        return sound(cfg, q, k, v, qpos, kpos, causal=causal,
                     kv_chunk=kv_chunk, **kw)[:, :S]

    assert fault in ("causal", "pad keys"), fault
    planted.window_skipped = sound.window_skipped
    attention._chunk_attn = planted
    try:
        yield
    finally:
        attention._chunk_attn = sound
        sound.window_skipped = planted.window_skipped


def unit_gain_params(cfg, seed: int, dev):
    """Seeded weights of ``cfg`` drawn on ``dev`` at unit gain: every leaf
    at 1/sqrt of its own first dimension. ``init_params`` draws a stacked
    layer's leaves as the reference does, at 1/sqrt(n_periods), and that
    gain turns attention into an argmax (PERF.md §7): a deep stack's bf16
    and f32 logits then part by about their size (phase 19 prints it for
    hubert-xlarge), so no precision can be held on it."""
    from repro_torch.models.model import model_defs
    from repro_torch.models.params import tree_init, tree_map
    return tree_init(tree_map(lambda d: dataclasses.replace(d, fan_in=0),
                              model_defs(cfg)), seed, dev)


def to_f32(tree, in_place: bool = False):
    """Every leaf of a parameter tree in f32: a new tree, or ``in_place``
    leaf by leaf (each bf16 leaf freed as its copy is made, so the peak
    holds one leaf twice, not the tree)."""
    from repro_torch.models.params import tree_map
    if not in_place:
        return tree_map(lambda t: t.float(), tree)
    for k in (list(tree) if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], (dict, list)):
            to_f32(tree[k], in_place=True)
        else:
            tree[k] = tree[k].float()
    return tree


def stack_share(got, want) -> float:
    """max |got - want| over max |want|."""
    w = want.float()
    return ((got.float() - w).abs().max() / w.abs().max()).item()


def serve_hubert(dev, smi: str) -> dict:
    """Phase 19: hubert-xlarge at full width and depth (48 layers, d 1280,
    16 heads of 80, GeGLU of 5120, an audio frontend of 512 features, no
    Engram, so no kernel of the port runs): the encoder step
    (``build_encoder_step``) over seeded frames, B = 8, at S = 512 and S =
    2100 (past ``chunk_threshold`` 2048: ``_chunk_attn(causal=False)`` in
    every layer, its last KV chunk holding 972 pad keys). The reference's
    draw (``init_params``) first: its bf16 logits against an f32
    evaluation, printed, not held. Then a unit-gain draw
    (``unit_gain_params``), held three ways within ``STACK_TOL``: bf16
    against f32 at S = 512; chunked against dense (``chunk_threshold``
    raised) at S = 2100; and frames changed at the last 5 positions must
    move the logits at position 0 (the mask is not causal). Each fault of
    ``planted_mask`` in the chunked path at S = 2100 must part from the
    dense path by more than ``STACK_TOL``. Device time, frames/s and peak
    memory at both lengths."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_encoder_step, init_params
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import RunFlags
    cfg = get_config("hubert-xlarge")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    label, B = "hubert-xlarge", 8
    gen = torch.Generator(device=dev).manual_seed(19)
    frames = {S: {"frames": torch.randn(B, S, cfg.frontend_dim,
                                        generator=gen, device=dev)}
              for S in (512, 2100)}
    step = build_encoder_step(cfg, RunFlags())
    step32 = build_encoder_step(cfg32, RunFlags())
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    a = step(params, frames[512])
    b = step32(to_f32(params), frames[512])
    ref_share = stack_share(a, b)
    ref_agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"{label}: {cfg.n_layers} layers d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters; the reference's draw "
          f"(stacked leaves at 1/sqrt(48)): bf16 logits against f32 at B = "
          f"{B}, S = 512 part by {ref_share:.4f} of the largest (argmax "
          f"equal at {100 * ref_agree:.1f} % of positions), not held")
    del params, a, b
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = unit_gain_params(cfg, 0, dev)
    a = step(params, frames[512])
    b = step32(to_f32(params), frames[512])
    share = stack_share(a, b)
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    check(tuple(a.shape) == (B, 512, cfg.vocab_size)
          and bool(torch.isfinite(a).all()), f"{label}: logits "
          f"{tuple(a.shape)} not finite")
    check(share <= STACK_TOL, f"{label}: bf16 logits {share:.4f} of the "
          f"largest from f32")
    moved = {"frames": frames[512]["frames"].clone()}
    moved["frames"][:, -5:] += 1.0
    back = (step(params, moved)[:, 0] - a[:, 0]).abs().max().item()
    check(back > 0, f"{label}: frames at positions 507 to 511 left the "
          f"logits at position 0 unchanged: the mask is causal")
    del b
    dense = build_encoder_step(cfg, RunFlags(chunk_threshold=4096))
    lc, ld = step(params, frames[2100]), dense(params, frames[2100])
    cshare = stack_share(lc, ld)
    check(cshare <= STACK_TOL, f"{label}: chunked logits at S = 2100 "
          f"{cshare:.4f} of the largest from the dense path's")
    del lc
    planted = {}
    for fault in ("causal", "pad keys"):
        with planted_mask(fault):
            planted[fault] = stack_share(step(params, frames[2100]), ld)
    print(f"{label} [{smi}]: planted in the chunked path at S = 2100, "
          + "; ".join(f"{f} {x:.4f}" for f, x in planted.items())
          + f" of the largest logit from the dense path's (STACK_TOL "
          f"{STACK_TOL})")
    for fault, x in planted.items():
        check(x > STACK_TOL, f"{label}: a planted {fault} mask reads "
              f"{x:.4f}, within STACK_TOL {STACK_TOL}: it cannot see it")
    del ld
    print(f"{label} [{smi}]: unit-gain draw: bf16 logits against f32 at S "
          f"= 512 part by {share:.4f} of the largest (argmax equal at "
          f"{100 * agree:.1f} %); at S = 2100 the chunked non-causal path "
          f"(3 KV chunks of 1024, 972 pad keys masked) against the dense "
          f"one {cshare:.4f}; both within {STACK_TOL}; frames changed at "
          f"positions 507 to 511 move position 0's logits by {back:.4f}")
    out = dict(ref_draw_share=ref_share, share=share, chunked_share=cshare,
               planted=planted)
    for S in (512, 2100):
        args = [(params, frames[S])]
        ops = device_ops(step, args, warmup=1)
        dms = sum(e.time_range.elapsed_us() for e in ops) / 1e3
        check(dms > 0, "the profiler recorded no device time")
        ms = call_ms(step, args * 3, warmup=1)
        out[S] = dict(device_ms=dms, ms=ms, frames_per_s=B * S / ms * 1e3)
        print(f"{label} encoder step B = {B}, S = {S} [{smi}]: device "
              f"{dms:.3f} ms in {len(ops)} operations, call {ms:.3f} ms "
              f"(CUDA events), {B * S / ms * 1e3:.0f} frames/s; top "
              f"kernels: {top_kernels(ops)}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 80, f"{label}: peak device memory {peak:.2f} GB")
    print(f"{label} [{smi}]: peak device memory {peak:.2f} GB (bf16 and f32 "
          f"weights, the dense S = 2100 pass's f32 scores)")
    out["peak_gb"] = peak
    del params
    return out


def serve_internvl(dev, smi: str) -> tuple:
    """Phase 20: internvl2-1b at full width and depth (24 layers, d 896, 14
    query and 2 KV heads of 64, a 151,655-word vocabulary, a vision stub
    of 256 patch tokens of 1024 features; ENGRAM_27B tables at layers 2
    and 10, 23.2 GB in HBM), drawn at unit gain (``unit_gain_params``),
    ``pool="CXL"``: K2 at d = 896 (T = 8, 256) and K1 on its tables
    first; serve's mix (phase 7's 8 prompts, 16 new tokens) twice after a
    warm-up, identical streams, phase 7's launch and read budgets, then 4
    steady waves profiled; then one prefill of 2 prompts of 320 tokens
    whose first 256 positions are the image's (id 0), with 256 seeded
    patch tokens: its logits must differ from the tokens-only prefill's
    (the frontend is live), and, the tree converted to f32 in place, lie
    within ``STACK_TOL`` of an f32 evaluation's. Returns the counted
    launches, K1's and K2's timings and the rest."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import with_f32_head
    from repro_torch.models.model import build_prefill_step
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import Engine
    cfg = get_config("internvl2-1b")
    e, label = cfg.engram, "internvl2-1b"
    gen = torch.Generator(device=dev).manual_seed(20)
    k2 = {n_t: time_k2(gen, dev, n_t, cfg.d_model,
                       len(e.orders) * e.emb_dim) for n_t in (8, 256)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = with_f32_head(unit_gain_params(cfg, 0, dev))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for k, v in params.items() if k != "engram"
                   for t in tree_leaves(v))
    print(f"{label}: {cfg.n_layers} layers d_model {cfg.d_model} vocab "
          f"{cfg.vocab_size}, engram layers {cfg.engram_layers()}: "
          f"{n_params / 1e9:.3f} B parameters beside the tables (f32 head "
          f"included), unit-gain draw in {time.perf_counter() - t0:.1f} s")
    k1 = time_k1_tables([layer["tables"] for layer in
                         params["engram"]["layers"]], dev, smi, label)
    eng = Engine(cfg, params=params, pool="CXL", max_batch=8, max_len=512,
                 prompt_bucket=32, device=dev)
    prompts = serve_prompts(cfg)
    eng.warmup(prompts)
    rt = eng.runtime()
    launches = dict.fromkeys(read_launches(), 0)
    first = None
    for rep in range(2):
        got, streams, summary = serve_once(cfg, eng, rt, prompts, dev, smi,
                                           rep)
        first = first or streams
        check(streams == first, f"{label}: run {rep + 1}'s streams differ "
              f"from run 1's")
        for k in launches:
            launches[k] += got[k]
    prof = profile_waves(eng, rt, prompts, label=f"{label} profile")
    del eng, rt
    gc.collect()
    tokens = torch.randint(1, cfg.vocab_size, (2, 320), generator=gen,
                           device=dev)
    tokens[:, :cfg.n_patch_tokens] = 0
    batch = {"tokens": tokens, "patches": torch.randn(
        2, cfg.n_patch_tokens, cfg.frontend_dim, generator=gen, device=dev)}
    pre = build_prefill_step(cfg, RunFlags(), max_len=512)
    with_p = pre(params, batch)[0]
    plain = pre(params, {"tokens": tokens})[0]
    live = (with_p - plain).abs().max().item()
    check(live > 0, f"{label}: patches left the prefill logits unchanged")
    peak16 = torch.cuda.max_memory_allocated() / 1e9
    to_f32(params, in_place=True)
    gc.collect()
    want = build_prefill_step(dataclasses.replace(cfg, dtype="float32"),
                              RunFlags(), max_len=512)(params, batch)[0]
    share = stack_share(with_p, want)
    agree = (with_p.argmax(-1) == want.argmax(-1)).float().mean().item()
    check(share <= STACK_TOL, f"{label}: bf16 prefill logits with patches "
          f"{share:.4f} of the largest from f32")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(peak < 80, f"{label}: peak device memory {peak:.2f} GB")
    print(f"{label} vision prefill [{smi}]: 2 x 320 tokens, 256 patch "
          f"tokens projected over positions 0 to 255: logits move by up to "
          f"{live:.4f} against the tokens-only prefill; bf16 against f32 "
          f"(tables converted in place) {share:.4f} of the largest (within "
          f"{STACK_TOL}), argmax equal on {100 * agree:.0f} % of rows; peak "
          f"device memory {peak16:.2f} GB serving in bf16, {peak:.2f} GB "
          f"with the f32 tree")
    del params, want, with_p, plain
    return launches, k1, k2, dict(profile=prof, share=share, live=live,
                                  wave_ms=summary["wave_ms"], peak_gb=peak16)


def serve_cli(cfg, params, dev, smi: str) -> dict:
    """Phase 21: the serving CLI's path on full-width engram-27b with phase
    7's parameters. (a) ``launch.serve.run_once(cfg, params=params,
    requests=8, max_new=16, pool="CXL")``, which serves with
    ``attn_bf16_scores`` as the reference's does, and the same workload
    through ``serve()`` with phase 7's flags (f32 scores): K1 once per
    decode wave, K2 twice per wave and admission group, one read per
    decode wave and two per admission group (the first wave after it
    reads its keys apart, as in phase 7); each prompt's logits teacher-
    forced along its bf16-score stream, both ways, within 16 bf16 ulps of
    |logit| + row RMS (``ulps_share``); whether the streams are equal, and
    where they part the top-2 logits of both. (b) 4 steady decode waves
    profiled each way, and one layer's attention core (``_sdpa``) at B =
    8 over a bf16 cache of S = 256 (the run's ``max_len``) and 4096
    positions timed each way: its share of a wave (times the layers).
    (a)'s drives are not a comparison: the first includes cuBLAS's first
    calls at these shapes. (c) One 40-token prompt admitted by chunks of 16 in
    admission groups of 1, 4 and 8 rows (the other rows 40-token prompts
    too): its first-token logits and 16-token streams compared across the
    groups, printed, not held (ROADMAP's ground rule that chunked
    admission does not depend on the group). Returns the kernels' launches
    over (a)'s two runs."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import run_once
    from repro_torch.models.attention import _sdpa
    from repro_torch.models.model import (build_decode_step,
                                          build_prefill_step)
    from repro_torch.models.transformer import RunFlags
    from repro_torch.serving import Engine, Workload, serve
    label = "cli"
    runs = {}
    for name in ("bf16", "f32"):
        reset_launches()
        if name == "bf16":
            fe, st = run_once(cfg, params=params, requests=8, max_new=16,
                              pool="CXL", device=dev)
        else:
            fe = serve(cfg, Workload(requests=8, max_new=16, seed=0),
                       pool="CXL", params=params, flags=RunFlags(),
                       max_batch=8, max_len=256, seed=0, device=dev).frontend
            st = fe.engine.stats
        eng, got = fe.engine, read_launches()
        check(eng.flags.attn_bf16_scores == (name == "bf16"),
              f"{label}: {name} engine flags {eng.flags}")
        streams = [eng.done[r].out for r in sorted(eng.done)]
        check(len(streams) == 8 and all(len(t) == 16 for t in streams),
              f"{label} {name}: not every request emitted 16 tokens")
        check(got["engram_gather"] == st.decode_steps
              and got["gated_fuse"] == 2 * (st.prefill_waves
                                            + st.decode_steps)
              and st.d2h_pulls == 2 * st.prefill_waves + st.decode_steps,
              f"{label} {name}: launches {got}, reads {st.d2h_pulls} for "
              f"{st.prefill_waves} groups and {st.decode_steps} waves")
        runs[name] = dict(fe=fe, streams=streams, launches=got,
                          tok_s=st.tokens_per_s)
        print(f"{label} (a) {name} scores [{smi}]: 8 requests x 16 tokens, "
              f"{st.prefill_waves} admission group(s), {st.decode_steps} "
              f"decode waves, K1 {got['engram_gather']}, K2 "
              f"{got['gated_fuse']} launches, {st.d2h_pulls} reads; "
              f"{st.tokens_per_s:.2f} tok/s over the drive")
    prompts = [list(s_.prompt) for s_ in
               Workload(requests=8, max_new=16, seed=0).build(cfg.vocab_size)]
    bf, f3 = runs["bf16"]["streams"], runs["f32"]["streams"]
    # teacher-forced: each prompt's bf16-score stream, both ways
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    toks = torch.zeros((8, 32), dtype=torch.long, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    forced = torch.tensor(bf, device=dev)                 # (8, 16)
    logits = {}
    for name, flags in (("bf16", RunFlags(attn_bf16_scores=True)),
                        ("f32", RunFlags())):
        lg, state = build_prefill_step(cfg, flags, max_len=256)(
            params, {"tokens": toks, "lengths": lens})
        out = [lg]
        decode = build_decode_step(cfg, flags)
        for j in range(15):
            lg, state = decode(params, state, forced[:, j])
            out.append(lg)
        logits[name] = torch.stack(out, 1)                 # (8, 16, V)
    share = ulps_share(logits["bf16"], logits["f32"])
    worst = (logits["bf16"] - logits["f32"]).abs().max().item()
    check(share <= 1.0, f"{label}: teacher-forced bf16-score logits "
          f"{share:.3f} x the tolerance from the f32-score ones")
    same = sum(a == b for a, b in zip(bf, f3))
    parts = []
    for i, (a, b) in enumerate(zip(bf, f3)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        tops = {n: logits[n][i, j].float().topk(2) for n in logits}
        parts.append(f"prompt {i} at token {j} ({a[j]} against {b[j]}): "
                     + ", ".join(f"{n} top-2 {t.indices.tolist()} "
                                 f"{[round(v, 5) for v in t.values.tolist()]}"
                                 for n, t in tops.items()))
        break
    print(f"{label} (a) [{smi}]: teacher-forced logits along the bf16 "
          f"streams, bf16 against f32 scores: max |diff| {worst:.5f}, "
          f"{share:.3f} of the tolerance (16 bf16 ulps of |logit| + row "
          f"RMS); streams equal on {same} of 8 prompts"
          + (f"; first parting: {parts[0]}" if parts else ""))
    del logits
    # (b) 4 steady waves each way, and one layer's decode attention
    prof = {}
    for name in ("bf16", "f32"):
        fe = runs[name]["fe"]
        prof[name] = profile_waves(fe.engine, fe, prompts,
                                   label=f"{label} (b) {name} scores")
    # the score route's own cost: _sdpa over a bf16 cache, one layer
    B, core = 8, {}
    g = torch.Generator(device=dev).manual_seed(21)
    for S in (256, 4096):
        q = [torch.randn(B, 1, cfg.n_heads, cfg.head_dim, generator=g,
                         device=dev).to(torch.bfloat16) for _ in range(4)]
        kv = [[torch.randn(B, S, cfg.n_kv_heads, cfg.head_dim, generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(2)]
              for _ in range(4)]
        mask = (torch.arange(S, device=dev) < S - 7)[None, None, :]
        core[S] = {name: device_ms(
            lambda q_, k_, v_, _b=bf16: _sdpa(cfg, q_, k_, v_, mask, _b),
            [(a, *c) for a, c in zip(q, kv)], warmup=2)
            for name, bf16 in (("bf16", True), ("f32", False))}
        del q, kv
    n_attn = cfg.layer_types.count("attn")
    for name in ("bf16", "f32"):
        print(f"{label} (b) {name} scores [{smi}]: wave device "
              f"{prof[name]['dev_ms']:.3f} ms in {prof[name]['ops']:.0f} "
              f"operations (wall {prof[name]['wall_ms']:.3f} ms); one "
              f"layer's attention core (_sdpa, B = {B}) "
              + ", ".join(f"S = {S}: {core[S][name]:.5f} device ms"
                          for S in core)
              + f"; at S = 256, x {n_attn} layers "
              f"{100 * n_attn * core[256][name] / prof[name]['dev_ms']:.1f}"
              f" % of the wave")
    print(f"{label} (b) [{smi}]: a layer's K and V cache at B = {B} is "
          + ", ".join(f"{2 * B * S * cfg.n_kv_heads * cfg.head_dim * 2 / 1e6:.1f}"
                      f" MB at S = {S}" for S in core)
          + " in bf16 (counted from the shapes); the f32 route writes and "
          "reads an f32 copy of K, the bf16 route a bf16 copy; attention "
          "core device time f32 / bf16 = "
          + ", ".join(f"{core[S]['f32'] / core[S]['bf16']:.2f} at S = {S}"
                      for S in core)
          + " (the reference claims about 7x less decode cache traffic; "
          "bytes are not measured)")
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["bf16"]["launches"]}
    del runs, fe
    gc.collect()
    # (c) chunked admission in groups of 1, 4 and 8 rows
    rng = np.random.RandomState(21)
    group = [list(rng.randint(1, cfg.vocab_size, size=40)) for _ in range(8)]
    eng = Engine(cfg, params=params, pool="CXL", max_batch=8, max_len=512,
                 prompt_bucket=32, prefill_chunk=16, device=dev)
    chunk_core, target, first, out = eng._chunk_core, [None], [None], {}

    def recording(p, sub, chunk, lens_):
        lg, new = chunk_core(p, sub, chunk, lens_)
        rids = [eng._prefill_jobs[s_].req.rid
                for s_ in sorted(eng._prefill_jobs)]
        if target[0] in rids:          # the target's row, till its last chunk
            first[0] = lg[rids.index(target[0])]
        return lg, new
    eng._chunk_core = recording
    for n in (1, 4, 8):
        rids = [eng.submit(p, max_new=16) for p in group[:n]]
        target[0] = rids[0]
        eng.run()
        out[n] = (first[0].float(), eng.done[rids[0]].out)
    base_lg, base_s = out[1]
    diffs = {n: (lg - base_lg).abs().max().item() for n, (lg, _) in
             out.items()}
    same = {n: s_ == base_s for n, (_, s_) in out.items()}
    print(f"{label} (c) [{smi}]: a 40-token prompt by chunks of 16 in "
          f"admission groups of 1, 4 and 8 rows: first-token logits max "
          f"|diff| from the group of 1 {diffs[4]:.6f} (4 rows), "
          f"{diffs[8]:.6f} (8 rows); streams equal to the group of 1's: "
          f"{same[4]} (4), {same[8]} (8); top-2 at token 0 "
          + "; ".join(f"{n} rows {lg.topk(2).indices.tolist()} "
                      f"{[round(v, 5) for v in lg.topk(2).values.tolist()]}"
                      for n, (lg, _) in out.items()))
    del eng
    return dict(launches=launches, share=share, attn=core, prof=prof,
                groups=diffs, group_streams_equal=same)


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
    from repro_torch.configs import (deepseek_v2_236b, deepseek_v3_671b,
                                     engram_27b, gemma2_27b, gemma3_1b,
                                     get_config, internvl2_1b,
                                     jamba_1_5_large_398b, xlstm_125m)
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
    for mod in (engram_27b, jamba_1_5_large_398b, xlstm_125m):
        check_agreement_overload(dev, mod)
        check_agreement_tiers(dev, mod)
    check_agreement_fleet(dev)
    check_agreement_models(dev, (gemma2_27b, gemma3_1b), (False, True))
    check_agreement_models(dev, (deepseek_v2_236b, deepseek_v3_671b))
    check_agreement_models(dev, (jamba_1_5_large_398b, xlstm_125m),
                           recurrent=True)
    check_agreement_models(dev, (internvl2_1b,))
    check_agreement_frontends(dev)
    params = draw_params(cfg, dev)
    launches, streams, serve7 = serve_full(cfg, params, dev, smi)
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

    # phase 21: the serving CLI's path, bf16 against f32 scores
    t21 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cli = serve_cli(cfg, params, dev, smi)
    for k, n in cli["launches"].items():
        launches[k] += n
    print(f"cli: phase 21 took {time.perf_counter() - t21:.1f} s")

    # phase 14: the tables in host memory; each model freed before the next
    t14 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    host_launches, k1_host, host_tables = serve_host_27b(
        cfg, params, dev, smi, prompts, streams, serve7)
    del params
    k2_host = {}
    for name, kw in (("deepseek-coder-33b", {}),
                     ("gemma2-27b", dict(max_new=16, reps=2)),
                     ("engram-40b", {})):
        gc.collect()
        torch.cuda.empty_cache()
        # coder-33b's and gemma2-27b's tables have engram-27b's shape: its
        # buffers are reused, then freed before engram-40b's 74 GB are
        # registered
        if name == "engram-40b":
            host_tables = None
            gc.collect()
        n, k2_host[name], host_tables, _ = serve_host_model(
            get_config(name), dev, smi, host_tables, **kw)
        for k in host_launches:
            host_launches[k] += n[k]
    for k, n in host_launches.items():
        launches[k] += n
    print(f"host: phase 14 took {time.perf_counter() - t14:.1f} s")

    # phase 16: deepseek-v2-236b, 9 layers, in engram-40b's host buffers
    t16 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    n, k2_v2, v2 = serve_deepseek_v2(dev, smi, host_tables)
    gc.collect()
    for k in launches:
        launches[k] += n[k]
    print(f"deepseek-v2: phase 16 took {time.perf_counter() - t16:.1f} s")

    # phase 17: jamba-1.5-large-398b, 7 layers, in the same host buffers
    t17 = time.perf_counter()
    torch.cuda.empty_cache()
    n, k2_jamba, jamba = serve_jamba(dev, smi, host_tables)
    del host_tables
    gc.collect()
    for k in launches:
        launches[k] += n[k]
    print(f"jamba: phase 17 took {time.perf_counter() - t17:.1f} s")

    # phase 15: gemma3-1b, its tables in HBM
    t15 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    g3_launches, k2_g3 = serve_gemma3(dev, smi)
    for k, n in g3_launches.items():
        launches[k] += n
    print(f"gemma3-1b: phase 15 took {time.perf_counter() - t15:.1f} s")

    # phase 18: xlstm-125m, its tables in HBM
    t18 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    n, k1_x, k2_x, xl = serve_xlstm(dev, smi)
    for k in launches:
        launches[k] += n[k]
    print(f"xlstm-125m: phase 18 took {time.perf_counter() - t18:.1f} s")

    # phase 19: hubert-xlarge, the encoder (no kernel of the port)
    t19 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    hub = serve_hubert(dev, smi)
    print(f"hubert-xlarge: phase 19 took {time.perf_counter() - t19:.1f} s")

    # phase 20: internvl2-1b, the vision stub, its tables in HBM
    t20 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    n, k1_vl, k2_vl, vl = serve_internvl(dev, smi)
    for k in launches:
        launches[k] += n[k]
    print(f"internvl2-1b: phase 20 took {time.perf_counter() - t20:.1f} s")

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
          "the serve, long-prompt, chunked, spec, overload, tiers, fleet, "
          "host-table (engram-27b, deepseek-coder-33b, gemma2-27b, "
          "engram-40b), deepseek-v2-236b (9 layers), jamba-1.5-large-398b "
          "(7 layers), gemma3-1b, xlstm-125m, CLI (bf16 and f32 scores) and "
          "internvl2-1b runs; also measured "
          "(deepseek-v2's MoE layer: ms the grouped-GEMM path, plain_ms "
          "the per-expert loop; host rows: plain_ms is the CPU gather and "
          "library_ms the reference's route, both on the host clock; bound "
          "at PCIe Gen5 x16's nominal 64 GB/s, link_GBps the rate measured "
          "in the run; recurrent layers: ms a decode step at B=8, "
          "prefill_ms a 256-token prefill at B=1, shares of the 16-bf16-ulp "
          "tolerance; hubert: the encoder step at B=8; cli: one layer's "
          "attention core at B=8 over S cached positions, device ms): "
          + json.dumps({"engram_gather_host_2x128_decode_wave":
                        k1_host["wave"],
                        "engram_gather_host_2x512_verify_wave":
                        k1_host["spec"],
                        "gated_fuse_d7168_T8":
                        k2_host["deepseek-coder-33b"][8],
                        "gated_fuse_d7168_T256":
                        k2_host["deepseek-coder-33b"][256],
                        "gated_fuse_d6144_T8": k2_host["engram-40b"][8],
                        "gated_fuse_d6144_T256": k2_host["engram-40b"][256],
                        "gated_fuse_d4608_T8": k2_host["gemma2-27b"][8],
                        "gated_fuse_d4608_T256": k2_host["gemma2-27b"][256],
                        "gated_fuse_d5120_T8_deepseek_v2": k2_v2[8],
                        "gated_fuse_d5120_T256_deepseek_v2": k2_v2[256],
                        "moe_layer_deepseek_v2_T8": v2[8],
                        "moe_layer_deepseek_v2_T256": v2[256],
                        "mla_decode_layer_deepseek_v2_B8_S512_ms":
                        v2["mla_ms"],
                        "gated_fuse_d1152_T8": k2_g3[8],
                        "gated_fuse_d1152_T256": k2_g3[256],
                        "gated_fuse_d1152_T2112": k2_g3[2112],
                        "gated_fuse_d8192_T8_jamba": k2_jamba[8],
                        "gated_fuse_d8192_T256_jamba": k2_jamba[256],
                        "engram_gather_host_2x128_jamba": jamba["k1"],
                        "mamba_layer_jamba": jamba["layer"],
                        "jamba_mamba_share_of_wave_device_time":
                        jamba["share"],
                        "jamba_chunked_first_token_share":
                        jamba["agree"]["share"],
                        "jamba_2100_ttft_ms": jamba["ttft_ms"],
                        "jamba_2112_scan_ms": jamba["scan_ms"],
                        "gated_fuse_d768_T8": k2_x[8],
                        "gated_fuse_d768_T256": k2_x[256],
                        "engram_gather_2x128_192B_xlstm": k1_x,
                        "mlstm_layer_xlstm": xl["layers"]["mlstm"],
                        "slstm_layer_xlstm": xl["layers"]["slstm"],
                        "xlstm_chunked_first_token_share":
                        xl["agree"]["share"],
                        "xlstm_512_ttft_ms": xl["ttft_ms"],
                        "gated_fuse_d896_T8_internvl": k2_vl[8],
                        "gated_fuse_d896_T256_internvl": k2_vl[256],
                        "engram_gather_2x128_internvl": k1_vl,
                        "internvl_bf16_vs_f32_prefill_share": vl["share"],
                        "hubert_encoder_B8_S512": hub[512],
                        "hubert_encoder_B8_S2100": hub[2100],
                        "hubert_bf16_vs_f32_share": hub["share"],
                        "hubert_reference_draw_share":
                        hub["ref_draw_share"],
                        "hubert_chunked_vs_dense_share":
                        hub["chunked_share"],
                        "cli_attention_core_ms": cli["attn"],
                        "cli_teacher_forced_share": cli["share"],
                        "cli_chunked_group_first_logit_diff":
                        cli["groups"],
                        "engram_gather_2x512_verify_wave": k1["spec"],
                        "engram_gather_N128_one_table": k1[16 * 8],
                        "engram_gather_N4096_one_table": k1[16 * 8 * 32],
                        "gated_fuse_T32": k2[32],
                        "gated_fuse_T64": k2[64],
                        "gated_fuse_T96": k2[96],
                        "gated_fuse_T128": k2[128],
                        "gated_fuse_T256": k2[256],
                        "gated_fuse_T2112": k2[2112]}))
    print(f"profiler: {len(CUPTI_LOST)} sessions lost {min(CUPTI_LOST)} to "
          f"{max(CUPTI_LOST)} of their {CUPTI_PRIME + 1} priming records "
          f"({CUPTI_LOST.count(CUPTI_PRIME + 1)} lost the marker too and "
          f"were measured again), "
          f"in order {CUPTI_LOST}; device times count only the records "
          f"after each session's marker")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
