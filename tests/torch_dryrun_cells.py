"""The dry-run cells of tests/test_torch_dryrun.py, in a process of their
own: ``launch.dryrun`` makes this process rank 0 of a fake world of 256
(or 512) ranks, a process group no test process may keep.

    PYTHONPATH=src python tests/torch_dryrun_cells.py OUT.json

Writes one JSON object: the records of a full-width cell (gemma3-1b x
decode_32k, single pod on the meta device and on the CPU path, the
multi-pod mesh, and again with ``unroll``), of reduced deepseek-v2's
train and decode steps in bf16 with 16 experts (one a rank of the model
axis: MoE under expert parallelism, ``torch._grouped_mm`` on the meta
device, whose shape function takes bf16 only, as the card's kernel
does), the collectives recorded by ``roofline.counting.CountingMode``
from c10d calls on a (2, 8, 16) mesh of the fake world, the report
rendered over the records, and the meta cell again with ``zero1``; and,
through the hillclimb driver (``repro_torch.experiments.hillclimb``),
reduced jamba's long_500k cell in bf16 with ``cell_rules``' ``kv_seq``
over "data" and with ``rule:kv_seq=`` (the sequence whole), each record
and whether its file was written.
"""
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import torch


def collective_calls() -> dict:
    """tests/test_roofline.py's four collectives, issued through the
    port's collectives on a (pod=2, data=8, model=16) mesh of the fake
    world of 256 ranks (model groups of 16, data groups of 8)."""
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline.counting import CountingMode
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.rules import sharding_ctx
    fake_world(256)
    mesh = make_mesh((2, 8, 16), ("pod", "data", "model"), "cpu")
    with sharding_ctx(mesh), CountingMode() as mode:
        coll.psum(torch.zeros(1024, 256), ("model",))
        coll.all_gather(torch.zeros(8, 128, dtype=torch.bfloat16),
                        ("data",))
        coll.psum_scatter(torch.zeros(64, 128), ("data",), dim=0)
        coll.all_to_all(torch.zeros(16, 32), ("model",))
    return mode.stats()["collectives"]


def main(out: str) -> None:
    torch.set_num_threads(2)
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.train import reduced_config
    from repro_torch.roofline import report
    recs = {
        "meta": lower_cell("gemma3-1b", "decode_32k", device="meta"),
        "cpu": lower_cell("gemma3-1b", "decode_32k", device="cpu"),
        "unroll": lower_cell("gemma3-1b", "decode_32k", device="meta",
                             unroll=True),
        "pod2": lower_cell("gemma3-1b", "decode_32k", device="meta",
                           multi_pod=True),
    }
    v2 = reduced_config("deepseek-v2-236b")
    v2 = dataclasses.replace(v2, dtype="bfloat16", moe=dataclasses.replace(
        v2.moe, n_experts=16))
    for shape in ("train_4k", "decode_32k"):
        recs[f"moe_{shape}"] = lower_cell("deepseek-v2-236b", shape,
                                          device="meta", cfg=v2)
    zero1 = lower_cell("gemma3-1b", "decode_32k", device="meta", zero1=True)
    kv_seq = hillclimb_cells()
    with tempfile.TemporaryDirectory() as d:
        for name, rec in recs.items():
            tag = "pod2" if name == "pod2" else "pod1"
            Path(d, f"{tag}__{name}__{rec['shape']}.json").write_text(
                json.dumps(rec))
        rendered = report.render(report.load_cells(Path(d)))
    Path(out).write_text(json.dumps({
        "records": recs, "collectives": collective_calls(),
        "report": rendered, "zero1": zero1, "kv_seq": kv_seq}))


def hillclimb_cells() -> dict:
    """Reduced jamba x long_500k (batch 1 under 16 data ranks) through the
    hillclimb driver: tag "kv_seq" with the cell's rules, tag "whole"
    with ``rule:kv_seq=``; each record, and whether its file was
    written."""
    from repro_torch.experiments import hillclimb
    from repro_torch.launch.train import reduced_config
    cfg = dataclasses.replace(reduced_config("jamba-1.5-large-398b"),
                              dtype="bfloat16")
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for tag, args in (("kv_seq", ["device=meta"]),
                          ("whole", ["device=meta", "rule:kv_seq="])):
            out[tag] = hillclimb.run("jamba-1.5-large-398b", "long_500k", tag,
                                     args, cfg=cfg, out_dir=Path(d))
            out[f"{tag}_written"] = Path(
                d, f"jamba-1.5-large-398b__long_500k__{tag}.json").exists()
    return out


if __name__ == "__main__":
    main(sys.argv[1])
