"""Roofline report: dry-run records -> markdown tables (PyTorch port of
``repro.roofline.report``).

Reads ``launch.dryrun``'s records (``build/dryrun/*.json``). They carry
the counting mode's stats under ``scaled``, so there is no HLO to
re-derive them from. Emits:

  * the dry-run table — trace ok and time, per-rank argument and peak
    bytes, collective mix, and the mesh axes of the KV sequence
    (``kv_seq``, the flash-decode split, where the cell's rules set it),
    for every (arch x shape x mesh) cell;
  * the roofline table — the three terms (compute, memory, collective
    seconds) on one H100 (``analysis.HW``), the dominant one, the ratio of
    model FLOPs per rank to the FLOPs counted, and the useful fraction,
    single-pod mesh only;
  * one lever per cell.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir build/dryrun]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs.base import SHAPES
from .analysis import HW, Roofline, roofline


def load_cells(dryrun_dir: Path) -> list[dict]:
    cells = []
    for f in sorted(Path(dryrun_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        rec["_file"] = f.name
        cells.append(rec)
    return cells


def cell_roofline(rec: dict) -> Roofline | None:
    s = rec.get("scaled")
    if not rec.get("ok") or not s:
        return None
    return roofline(s["flops_dot"], s["bytes_accessed"],
                    s["collectives"]["total_wire_bytes_per_device"])


def lever(rec: dict, r: Roofline) -> str:
    """One sentence: what would move the dominant term down."""
    kind = SHAPES[rec["shape"]].kind
    if r.bound == "collective":
        mix = rec["scaled"]["collectives"]["wire_bytes_per_device"]
        top = max(mix, key=mix.get) if mix else "?"
        if kind == "train":
            return (f"{top} dominates — overlap grad sync with backward, "
                    "int8-compress the DP all-reduce, or shard the dense "
                    "weights so fewer gradients cross the wire")
        return (f"{top} dominates — move the op to a masked-local+psum "
                "form or shrink the replicated operand")
    if r.bound == "memory":
        if kind == "decode":
            return ("KV-cache and weight traffic dominates — keep reads in "
                    "bf16 (no f32 cache copies), window-limit local layers, "
                    "split the KV sequence (kv_seq) where the KV heads "
                    "cannot fill the model axis")
        if kind == "train":
            return ("activation/optimizer traffic dominates — fuse the "
                    "elementwise passes and AdamW, stronger remat, ZeRO the "
                    "moments over data")
        return "stream weights once per step; fuse elementwise chains"
    return ("compute-bound — fewer remat recomputes, bf16 in place of the "
            "f32 head, heads gathered whole less often")


def fmt_bytes(b: float) -> str:
    if b >= 2**30:
        return f"{b / 2**30:.1f}G"
    if b >= 2**20:
        return f"{b / 2**20:.1f}M"
    return f"{b / 2**10:.0f}K"


def fmt_time(s: float) -> str:
    return f"{s * 1e3:.2f}" if s < 10 else f"{s * 1e3:.0f}"


def dryrun_table(cells: list[dict]) -> str:
    out = ["| mesh | arch | shape | ok | trace_s | args/rank | peak-est/rank "
           "| collective mix (wire/rank) | kv_seq |",
           "|---|---|---|---|---|---|---|---|---|"]
    for rec in cells:
        tag = "2x16x16" if "pod2" in rec["_file"] else "16x16"
        if not rec.get("ok"):
            out.append(f"| {tag} | {rec['arch']} | {rec['shape']} | FAIL | "
                       f"{rec.get('total_s', 0):.0f} | - | - | "
                       f"{rec.get('error', '')[:60]} | - |")
            continue
        mem = rec.get("memory", {})
        mix = rec["scaled"]["collectives"]["wire_bytes_per_device"]
        mix_s = " ".join(f"{k.replace('all-', 'a')[:7]}:{fmt_bytes(v)}"
                         for k, v in sorted(mix.items(),
                                            key=lambda kv: -kv[1])[:3])
        out.append(
            f"| {tag} | {rec['arch']} | {rec['shape']} | ok | "
            f"{rec.get('trace_s', 0):.0f} | "
            f"{fmt_bytes(mem.get('argument_bytes', 0))} | "
            f"{fmt_bytes(mem.get('peak_bytes_est', 0))} | {mix_s} | "
            f"{','.join(rec.get('rules', {}).get('kv_seq', [])) or '-'} |")
    return "\n".join(out)


def roofline_table(cells: list[dict]) -> str:
    out = ["| arch | shape | compute_ms | memory_ms | coll_ms | bound | "
           "step_ms | MODEL/counted flops | useful frac |",
           "|---|---|---|---|---|---|---|---|---|"]
    for rec in cells:
        if "pod2" in rec["_file"]:
            continue
        r = cell_roofline(rec)
        if r is None:
            continue
        mf = rec["model_flops"] / rec["n_devices"]
        ratio = mf / max(r.flops_per_device, 1.0)
        frac = (mf / HW["peak_flops"]) / max(r.step_time_s, 1e-12)
        out.append(
            f"| {rec['arch']} | {rec['shape']} | {fmt_time(r.compute_s)} | "
            f"{fmt_time(r.memory_s)} | {fmt_time(r.collective_s)} | "
            f"{r.bound} | {fmt_time(r.step_time_s)} | {ratio:.3f} | "
            f"{frac:.4f} |")
    return "\n".join(out)


def levers_list(cells: list[dict]) -> str:
    out = []
    for rec in cells:
        if "pod2" in rec["_file"]:
            continue
        r = cell_roofline(rec)
        if r is None:
            continue
        out.append(f"- **{rec['arch']} x {rec['shape']}** ({r.bound}-bound): "
                   f"{lever(rec, r)}")
    return "\n".join(out)


def summary(cells: list[dict]) -> dict:
    ok = [c for c in cells if c.get("ok")]
    fail = [c for c in cells if not c.get("ok")]
    return {"total": len(cells), "ok": len(ok), "fail": len(fail),
            "pod1": len([c for c in ok if "pod1" in c["_file"]]),
            "pod2": len([c for c in ok if "pod2" in c["_file"]])}


def render(cells: list[dict]) -> str:
    s = summary(cells)
    return "\n".join([
        f"Cells: {s['ok']}/{s['total']} ok "
        f"(pod1 {s['pod1']}, pod2 {s['pod2']}, fail {s['fail']})",
        "", "## Dry-run", "", dryrun_table(cells),
        "", "## Roofline (single-pod, one H100 per rank)", "",
        roofline_table(cells), "", "### Levers", "", levers_list(cells)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--out", default=None, help="write markdown here")
    args = ap.parse_args(argv)
    text = render(load_cells(Path(args.dir)))
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
