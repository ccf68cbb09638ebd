"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The cell (``BENCHMARK.json``) names a configuration and a traffic
mix; the run draws the weights and the prompts from ``--seed`` on the
card, builds the port's serving engine (``src/repro_torch``), warms up,
drives the mix's closed-loop clients for ``--seconds``, checks the served
tokens against the plain reference and prints one JSON object as the last
line of standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a profiler trace of
the window's last seconds.

``--control`` also reads the control (the reference in float8 products)
on the checked requests; ``--sweep N`` runs N seeds from ``--seed`` up in
one process, one result line each (the control's and the limits'
readings). Neither is part of a benchmark run.

Exits non-zero, printing no result, without enough CUDA devices, and when
JAX, Flax or the port's JAX reference package (``repro``) was loaded.
"""
import os
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (``/proc``: 10 ms ticks)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and keep libraries from loading JAX by themselves."""
    cache = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--sweep", type=int, default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from portbench.harness import bench
    from portbench.harness import cell as cells

    cell = cells.load(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the program; fails in a bare tree)
    dev = torch.device("cuda", 0)
    cfg, weights = bench.build(cell, dev)
    seeds = [args.seed + i for i in range(max(1, args.sweep))]
    outs = []
    for i, seed in enumerate(seeds):
        if i:
            torch.cuda.reset_peak_memory_stats(dev)
        out = bench.measure(cell, cfg, weights,
                            seed % (1 << 63), args.seconds,
                            bool(args.trace), dev,
                            T_START if i == 0 else time.perf_counter(),
                            control=args.control or args.sweep > 0)
        outs.append(out)
        if i + 1 < len(seeds):
            print(json.dumps(out), flush=True)
    bad = loaded_forbidden()
    if bad:
        print(f"refused: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    bench.report_checks(outs[-1])
    print(json.dumps(outs[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
