"""A configuration's family (``harness/family.py``): where no family file
names its ``model_type`` the harness's own mapping, reference and FLOPs
serve, unchanged; where one does, a whole run is built, served, checked
(the control too) and counted through that file's functions."""
import json
import time
import types

import pytest

from portbench.harness import bench, drive, family, model
from portbench.harness import cell as cells
from portbench.reference import model as reference
from portbench.roofline import flops, peaks

from . import tiny

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
OWN = {"model_config": model.model_config, "run_flags": model.run_flags,
       "Reference": reference.Reference, "prefill": flops.prefill,
       "decode": flops.decode}


@pytest.mark.parametrize(
    "c", [tiny.DENSE, dict(tiny.MLA_MOE, model_type="tiny_mla_moe")]
    + [cells.load(w["name"]).config for w in BENCH["workloads"]],
    ids=lambda c: c["name"])
def test_no_family_file_is_the_harness_own(c):
    fam = family.of(c)
    for m in family.MEMBERS:
        assert getattr(fam, m) is OWN[m]
    from repro_torch.models.transformer import RunFlags
    assert fam.run_flags(c) == \
        RunFlags(engram_strategy=c["engram"]["strategy"])


def test_a_member_left_out_is_the_harness_own(tmp_path):
    d = tmp_path / "portbench" / "families"
    d.mkdir(parents=True)
    (d / "tiny_mla_moe.py").write_text(
        "def prefill(c, n):\n    return 7.0 * n\n")
    fam = family.of(tiny.FAMILY_CONFIG, tmp_path)
    assert fam.prefill(tiny.FAMILY_CONFIG, 3) == 21.0
    for m in ("model_config", "run_flags", "Reference", "decode"):
        assert getattr(fam, m) is OWN[m]
    # found by model_type, not by the configuration's name
    assert family.of(dict(tiny.FAMILY_CONFIG, model_type="other"),
                     tmp_path).prefill is flops.prefill


@pytest.mark.parametrize("left_out", [("Reference", "prefill", "decode"),
                                      ("Reference",), ("prefill",),
                                      ("decode",)], ids="-".join)
def test_a_mapping_without_its_reference_and_flops_is_refused(tmp_path,
                                                              left_out):
    """A family that maps the configuration itself states another model
    than the harness's own reference checks and its FLOPs count: each of
    the three it leaves out refuses the family, at the cell's load."""
    d = tmp_path / "portbench" / "families"
    d.mkdir(parents=True)
    (d / "tiny_mla_moe.py").write_text("".join(
        f"def {m}(*a):\n    pass\n"
        for m in ("model_config",) + family.WITH_MAPPING
        if m not in left_out))
    with pytest.raises(ValueError, match=", ".join(left_out)):
        family.of(tiny.FAMILY_CONFIG, tmp_path)
    with pytest.raises(ValueError, match="maps the configuration itself"):
        cells.Cell("tiny.mix", "mix", 1, tiny.FAMILY_CONFIG, tiny.MIX, [],
                   [], tmp_path)


def _run(root, seconds, traced, control):
    pl = [{"name": "step_mfu", "unit": "%"}]
    e2e = [{"name": n, "unit": "u"} for n in ("tokens_per_s", "setup_s")]
    cell = cells.Cell("tiny.mix", "mix", 1, tiny.FAMILY_CONFIG, tiny.MIX,
                      e2e, pl, root)
    cfg, w = bench.build(cell, "cpu")
    return bench.measure(cell, cfg, w, 2 ** 31 + 17, seconds, traced, "cpu",
                         time.perf_counter(), control=control)


def test_a_family_drives_a_whole_run(tmp_path):
    with pytest.raises(ValueError, match="rope_scaling"):
        model.model_config(tiny.FAMILY_CONFIG)
    log = tiny.write_family(tmp_path)
    seconds = 4.0
    out = _run(tmp_path, seconds, traced=True, control=True)
    calls = log.read_text().splitlines()
    # built and served through the family's mapping and flags
    assert calls[:2] == ["model_config", "run_flags"]
    # checked by its reference, the control by the same in float8
    assert calls[2:4] == ["Reference NoneType", "Reference Float8Linear"]
    number, limit = (tiny.MLA_MOE["check"][k] for k in ("number",
                                                         "gap_limit"))
    assert out["correct"], out["checks"]
    assert out["run"]["served"][number] <= limit < out["control"][number]
    # counted by its FLOPs alone
    n_pre, n_dec = calls.count("prefill"), calls.count("decode")
    assert n_pre > 0 and n_dec > 0 and len(calls) == 4 + n_pre + n_dec
    want = 100.0 * (tiny.PREFILL_FLOPS * n_pre + tiny.DECODE_FLOPS * n_dec) \
        / (peaks.BF16_FLOP_PER_S * seconds)
    assert out["metrics"]["step_mfu"]["value"] == pytest.approx(want,
                                                               rel=1e-12)


def test_a_fault_in_the_family_reference_is_not_correct(tmp_path):
    """The family's reference decides ``correct``: one that leaves out the
    shared experts fails the program's sound tokens."""
    tiny.write_family(tmp_path, fault=True)
    out = _run(tmp_path, 4.0, traced=False, control=False)
    number = tiny.MLA_MOE["check"]["number"]
    assert not out["correct"], out["checks"]
    assert out["checks"][number]["value"] > \
        tiny.MLA_MOE["check"]["gap_limit"]
    assert out["failed"] > 0


def test_step_mfu_reads_the_family_flops():
    """Over a window of stamped requests: a prompt counted when its first
    token falls inside the window, each later token as a decode step at its
    position, all by the family's ``prefill`` and ``decode``."""
    seen = []

    def prefill(c, n):
        seen.append(("prefill", n))
        return 1e12

    def decode(c, pos):
        seen.append(("decode", pos))
        return 1e10

    reqs = [drive.Req(0, [1] * 5, 4, 0.0, stamps=[1.5, 2.0, 2.5, 9.0]),
            drive.Req(1, [1] * 3, 4, 0.0, stamps=[0.5, 1.2])]
    win = drive.Window(1.0, 3.0, [], reqs, 0)
    fam = types.SimpleNamespace(prefill=prefill, decode=decode)
    run = bench.Run(tiny.DENSE, win, 0.0, None, None, fam)
    got = cells.reader("step_mfu")(run)
    assert seen == [("prefill", 5), ("decode", 5), ("decode", 6),
                    ("decode", 3)]
    assert got == pytest.approx(100.0 * (1e12 + 3e10)
                                / (peaks.BF16_FLOP_PER_S * 2.0), rel=1e-12)
    assert cells.reader("step_mfu.itl")(run) == got
