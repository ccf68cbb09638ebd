"""Hillclimb driver: re-trace one dry-run cell with a named flag set and
named sharding-rule overrides, and print its three-term roofline (PyTorch
port of the reference's ``experiments/hillclimb.py``).

    PYTHONPATH=src python -m repro_torch.experiments.hillclimb <arch> \\
        <shape> <tag> [flag=value ...] [rule:axis=a,b ...]
    # e.g. attn_bf16_scores=true rule:kv_seq=model device=meta

``moe``, ``engram``, ``remat``, ``unroll`` and ``zero1`` go to
``launch.dryrun.lower_cell`` as in the reference, and so does ``device``
(default ``cuda``: the card's path on fake tensors; ``meta`` where
PyTorch has no CUDA); every other flag is a ``RunFlags`` field, and each
``rule:`` an override of ``cell_rules`` (an empty value: no mesh axis).
Writes ``build/hillclimb/<arch>__<shape>__<tag>.json``, the record with
``flags_extra``. The reference also writes the cell's HLO and prints its
compile time; the port traces, so it has neither.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

# keys that are lower_cell's arguments, not RunFlags fields
RESERVED = ("moe", "engram", "remat", "unroll", "zero1", "device")


def parse_flags(args):
    """``flag=value`` and ``rule:axis=a,b`` arguments -> (flags, rules):
    "true"/"false" as booleans, digits as ints (the reference's)."""
    out, rules = {}, {}
    for a in args:
        k, v = a.split("=", 1)
        if k.startswith("rule:"):
            rules[k[5:]] = tuple(v.split(",")) if v else ()
            continue
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        elif v.isdigit():
            v = int(v)
        out[k] = v
    return out, rules


def run(arch: str, shape: str, tag: str, args=(), *, cfg=None,
        out_dir: Path = Path("build/hillclimb")) -> dict:
    """Trace the cell, write its record and print its roofline line; the
    record. ``cfg``: a config traced in place of ``arch``'s (a reduced
    one)."""
    from ..launch.dryrun import lower_cell
    from ..roofline.analysis import roofline
    kv, rules = parse_flags(args)
    extra = {k: v for k, v in kv.items() if k not in RESERVED}
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{arch}__{shape}__{tag}"
    rec = lower_cell(arch, shape,
                     moe=kv.get("moe", "gather"),
                     engram_strategy=kv.get("engram"),
                     remat=kv.get("remat", True),
                     unroll=kv.get("unroll", False),
                     zero1=kv.get("zero1", False),
                     flags_extra=extra,
                     rules_extra=rules or None,
                     device=kv.get("device", "cuda"), cfg=cfg)
    rec["flags_extra"] = extra
    (out_dir / f"{stem}.json").write_text(json.dumps(rec, indent=1))
    if not rec["ok"]:
        print("FAIL:", rec["error"])
        return rec
    s = rec["scaled"]
    r = roofline(s["flops_dot"], s["bytes_accessed"],
                 s["collectives"]["total_wire_bytes_per_device"])
    print(f"{stem}: compute={r.compute_s*1e3:.2f}ms "
          f"mem={r.memory_s*1e3:.2f}ms coll={r.collective_s*1e3:.2f}ms "
          f"bound={r.bound}")
    return rec


def main(argv=None) -> int:
    import torch.distributed as dist
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(__doc__)
        return 2
    rec = run(*argv[:3], argv[3:])
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
