#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each of which must pass (any failure exits nonzero before the
result lines are printed):

  1. device   the card's name and power limit (nvidia-smi); TF32 off.
  2. build    both CUDA kernels from ``src/repro_torch/csrc`` into
              ``build/kernels/`` (one nvcc per source, in parallel).
  3. K1       engram_gather against its plain version, bit-equal, at the
              engram-27b table shape (16 x 2,265,088 x 160 bf16) and on
              small tables whose rows are not 16-byte aligned; timed.
  4. K2       gated_fuse against its plain version at d = 5120, F = 2560
              in bf16 (T = 8 and 256) and on small ragged shapes in bf16
              and float32; timed.
  5. agree    the reduced engram-27b config served on the card (kernels)
              and on the CPU (plain versions) in float32: identical token
              streams and matching prefill logits.
  6. serve    engram-27b at full width and full depth (36 layers, 22.9 B
              parameters, seeded random bf16 weights drawn on the card)
              behind ``Engine(pool="CXL", max_batch=8, max_len=512)``:
              after a warm-up at the same shapes, 8 requests with 16 new
              tokens each, twice: kernel launch counts, one device->host
              read per steady decode wave, no other sync.

The line before the last is a JSON object listing both kernels; the last
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
                                                   gather_rows_ref)
    from repro_torch.models.params import pd, tree_init
    e = cfg.engram
    T, V, hd = e.n_tables, padded_vocab(e), e.head_dim
    tables = tree_init(pd(T, V, hd, dtype="bfloat16", scale=1.0), 1, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    flat = tables.view(T * V, hd)
    row_bytes = hd * tables.element_size()
    result = {}
    for n in (16 * 8, 16 * 8 * 32):          # one decode wave; a 32-token
        gids = [torch.randint(0, T * V, (n,), generator=gen, device=dev)
                for _ in range(40)]           # prompt group of 8
        out = gather_rows(flat, gids[0])
        ref = gather_rows_ref(flat, gids[0])
        check(torch.equal(out.view(torch.int16), ref.view(torch.int16)),
              f"K1 not bit-equal at N={n}")
        err = (out.float() - ref.float()).abs().max().item()
        args = [(flat, g) for g in gids]
        index_select = lambda t, g: torch.index_select(t, 0, g)  # noqa
        ms = device_ms(gather_rows, args)
        plain = device_ms(gather_rows_ref, args)
        lib = device_ms(index_select, args)
        b_ms, b_by = bound(2 * n * row_bytes + 8 * n, 0)
        result[n] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        print(f"K1 gather_rows N={n} rows x {row_bytes} B: bit-equal; "
              f"device ms: kernel {ms:.5f}, plain {plain:.5f}, index_select "
              f"{lib:.5f}, byte bound {b_ms:.6f}; per call with launch: "
              f"kernel {call_ms(gather_rows, args):.5f}, plain "
              f"{call_ms(gather_rows_ref, args):.5f}, index_select "
              f"{call_ms(index_select, args):.5f}")
    idx = torch.randint(0, V, (8, 1, T), generator=gen, device=dev)
    check(torch.equal(engram_gather(tables, idx).view(torch.int16),
                      engram_gather_ref(tables, idx).view(torch.int16)),
          "K1 engram_gather (T sub-tables) not bit-equal")
    del tables, flat
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
    torch.cuda.synchronize()
    print("K1 unaligned rows (bf16 hd=7, f32 hd=5, bf16 stride-offset "
          "view, f64 hd=3): bit-equal")
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 4: K2
# ---------------------------------------------------------------------------

def check_k2(cfg, dev) -> dict:
    import torch
    from repro_torch.kernels.gated_fuse import (engram_gated_fuse,
                                                gated_fuse_ref)
    d = cfg.d_model
    F = len(cfg.engram.orders) * cfg.engram.emb_dim
    gen = torch.Generator(device=dev).manual_seed(2)

    def operands(n_t, d, F, dtype):
        mk = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa
        return (mk(n_t, d).to(dtype), mk(n_t, F).to(dtype),
                (mk(d, d) / math.sqrt(d)).to(dtype),
                (mk(F, d) / math.sqrt(F)).to(dtype))

    result = {}
    for n_t in (8, 256):                 # decode batch; 8 x 32-token prefill
        ops = operands(n_t, d, F, torch.bfloat16)
        out = engram_gated_fuse(*ops)
        ref = gated_fuse_ref(*ops)
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
        err = (out.float() - ref.float()).abs().max().item()
        sets = [ops] + [operands(n_t, d, F, torch.bfloat16)[:2] + ops[2:]
                        for _ in range(9)]
        ms = device_ms(engram_gated_fuse, sets)
        plain = device_ms(gated_fuse_ref, sets)
        nbytes = 2 * (2 * n_t * d + n_t * F + d * d + F * d)
        flops = 2 * n_t * d * (d + F)
        b_ms, b_by = bound(nbytes, flops)
        result[n_t] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                           library_ms=None, bound_ms=b_ms, bound_by=b_by)
        print(f"K2 gated_fuse T={n_t} d={d} F={F} bf16: max|err| {err:.3e} "
              f"within rtol=2^-7 atol=1e-3; device ms: kernel {ms:.5f}, "
              f"plain {plain:.5f}, bound {b_ms:.6f} ({b_by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); per call "
              f"with launch: kernel {call_ms(engram_gated_fuse, sets):.5f}")
    for n_t, dd, ff, dtype, tol in ((5, 100, 36, torch.bfloat16, BF16_TOL),
                                    (37, 98, 30, torch.float32, F32_TOL),
                                    (40, 128, 64, torch.float32, F32_TOL)):
        ops = operands(n_t, dd, ff, dtype)
        torch.testing.assert_close(engram_gated_fuse(*ops).float(),
                                   gated_fuse_ref(*ops).float(), **tol)
    print("K2 ragged shapes (bf16 5x100x36, f32 37x98x30 scalar loads, "
          "f32 40x128x64 vector loads): within tolerance")
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


# ---------------------------------------------------------------------------
# phase 6: the main path at full width
# ---------------------------------------------------------------------------

def serve_full(cfg, dev, smi: str, reps: int = 2) -> dict:
    """Serve 8 requests on full-width engram-27b, ``reps`` times after a
    warm-up at the same shapes; returns each kernel's launch count over
    the last run."""
    import numpy as np
    import torch
    from repro_torch.models.model import init_params
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving import Engine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"vocab {cfg.vocab_size} engram layers {cfg.engram_layers()}: "
          f"{n_params / 1e9:.3f} B parameters drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    eng = Engine(cfg, params=params, pool="CXL", max_batch=8, max_len=512,
                 prompt_bucket=32, device=dev)
    del params
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, cfg.vocab_size, size=n))
               for n in (5, 9, 12, 16, 20, 24, 28, 32)]
    eng.warmup(prompts)              # the measured 8 x 32 prefill group
    rt = eng.runtime()
    for rep in range(reps):
        launches = serve_once(cfg, eng, rt, prompts, dev, smi, rep)
    profile_waves(eng, rt, prompts)
    return launches


def serve_once(cfg, eng, rt, prompts, dev, smi: str, rep: int) -> dict:
    """One counted run of the main path: every request to completion with
    the kernels' launch counters and the engine's stats reset just before
    it; checks the counts, the reads per wave and the outputs."""
    import torch
    from repro_torch.kernels.engram_gather import gather_rows
    from repro_torch.kernels.gated_fuse import engram_gated_fuse
    eng.reset_stats()
    n_steps0 = len(eng._step_times)

    gather_rows.launches = 0
    engram_gated_fuse.launches = 0
    handles = [rt.submit(p, max_new=16) for p in prompts]
    pulls = []
    t_run = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            while eng.busy:
                before = eng.stats.d2h_pulls
                rt.step()
                pulls.append(eng.stats.d2h_pulls - before)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"engram_gather": gather_rows.launches,
                "gated_fuse": engram_gated_fuse.launches}

    st = eng.stats
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    check(not syncs, f"{len(syncs)} stray syncs on the wave: {syncs[:3]}")
    check(all(h.finished and len(h.tokens) == 16 for h in handles),
          "not every request completed with 16 tokens")
    check(all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens),
          "a token outside the vocabulary")
    check(launches["engram_gather"] == 2 * st.decode_steps,
          f"K1 launches {launches['engram_gather']} != 2 x "
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
    return launches


def profile_waves(eng, rt, prompts, max_new: int = 6) -> None:
    """Where a steady decode wave's time goes, from a short extra run after
    the counted one: wall time per wave, device time per wave (CUPTI, all
    kernels summed) and the kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        rt.submit(p, max_new=max_new)
    rt.step()                        # admission + the post-admission wave
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
    print(f"profile: {n} steady decode waves under the profiler: wall "
          f"{wall_ms / n:.3f} ms/wave, device busy {dev_ms / n:.3f} ms/wave "
          f"({100 * dev_ms / wall_ms:.1f} % of wall), {n_ops / n:.0f} "
          f"device kernels/copies per wave")
    for e in top:
        print(f"profile:   {e.self_device_time_total / 1e3 / n:9.4f} ms/wave"
              f"  {e.count / n:6.1f} calls/wave  {e.key[:90]}")


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
    launches = serve_full(cfg, dev, smi)

    kernels = [
        dict(name="engram_gather", route="cuda",
             source="src/repro_torch/csrc/engram_gather.cu",
             replaces="src/repro/kernels/engram_gather/engram_gather.py:30",
             launches=launches["engram_gather"], **k1[16 * 8]),
        dict(name="gated_fuse", route="cuda",
             source="src/repro_torch/csrc/gated_fuse.cu",
             replaces="src/repro/kernels/gated_fuse/gated_fuse.py:36",
             launches=launches["gated_fuse"], **k2[8]),
    ]
    print("shapes: engram_gather at N=128 rows (one decode wave), "
          "gated_fuse at T=8 (decode); also measured: "
          + json.dumps({"engram_gather_N4096": k1[16 * 8 * 32],
                        "gated_fuse_T256": k2[256]}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
