"""Trace one rank of one (arch x shape) cell on the 512-rank multi-pod mesh
and print its roofline terms on one H100 (PyTorch port of
``examples/multipod_dryrun.py``): the smallest end-to-end tour of the
distribution stack.

    PYTHONPATH=src python -m repro_torch.examples.multipod_dryrun \\
        [--arch gemma3-1b] [--shape decode_32k] [--single-pod] \\
        [--device cuda|meta|cpu]

Nothing is allocated and no card is needed: rank 0 of a fake world runs
its step on fake tensors (``launch.dryrun``). ``--device cuda`` (the
default) traces the card's path and needs a PyTorch built with CUDA;
``meta`` traces the same path on a CPU-only build.
"""
import argparse
import sys

from repro_torch.launch.dryrun import lower_cell
from repro_torch.roofline.analysis import roofline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    choices=["cuda", "meta", "cpu"])
    args = ap.parse_args(argv)

    rec = lower_cell(args.arch, args.shape, multi_pod=not args.single_pod,
                     device=args.device)
    if not rec["ok"]:
        print("FAILED:", rec["error"])
        return 1
    n = rec["n_devices"]
    r = roofline(rec["cost"]["flops"], rec["cost"]["bytes_accessed"],
                 rec["collectives"]["total_wire_bytes_per_device"])
    print(f"{rec['arch']} x {rec['shape']} on {rec['mesh']} "
          f"({n} ranks): traced rank 0 in {rec['trace_s']}s "
          f"({rec['n_ops']:.0f} operations)")
    print(f"  params {rec['params']/1e9:.1f}B "
          f"(active {rec['active_params']/1e9:.1f}B)")
    print(f"  per-rank arg bytes {rec['memory']['argument_bytes']/2**30:.2f} "
          f"GiB, peak {rec['memory']['peak_bytes_est']/2**30:.2f} GiB")
    print(f"  roofline: compute {r.compute_s*1e3:.2f} ms | "
          f"memory {r.memory_s*1e3:.2f} ms | "
          f"collective {r.collective_s*1e3:.2f} ms -> {r.bound}-bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
