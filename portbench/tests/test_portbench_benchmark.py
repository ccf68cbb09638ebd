"""``BENCHMARK.json`` and the files it names: every cell's configuration
and mix load, every configuration maps onto the port's ``ModelConfig``
through its family, every metric has its reader, and every reader of a
cell reads a whole window of the harness at a tiny size."""
import json
import re
import time

import pytest

from portbench.harness import bench
from portbench.harness import cell as cells

from . import tiny

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    cell = cells.load(w["name"])
    assert cell.chips == w["chips"] == 1
    cfg = cell.family.model_config(cell.config)
    assert cfg.n_layers == cell.config["num_hidden_layers"]
    assert cell.config["check"]["number"] in ("widest_gap", "mean_gap")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_names_and_readers():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"])
        assert callable(cells.reader(m["name"]))
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["name"] == \
            f"{w['config']}.{w['name'].split('.', 1)[1]}"


def test_every_reader_reads_a_window():
    """Each reader of the benchmark, over a tiny traced run on the CPU (no
    kernel: the kernels' readers find nothing and return None)."""
    e2e = [{"name": m["name"], "unit": m["unit"]}
           for m in BENCH["end_to_end"]]
    pl = [{"name": m["name"], "unit": m["unit"]} for m in BENCH["per_layer"]]
    cell = cells.Cell("tiny.mix", "mix", 1, tiny.DENSE, tiny.MIX, e2e, pl)
    cfg, w = bench.build(cell, "cpu")
    out = bench.measure(cell, cfg, w, 1, 4.0, True, "cpu",
                        time.perf_counter())
    got = set(out["metrics"])
    assert {"step_ms.decode", "step_ms.admit", "step_mfu",
            "step_mfu.itl"} <= got
    assert out["metrics"]["step_mfu.itl"] == out["metrics"]["step_mfu"]
    assert out["metrics"]["step_ms.admit.chat"] == \
        out["metrics"]["step_ms.admit"]
    sp = out["run"]["step_ms"]
    assert 0 < sp["decode_n"] + sp["admit_n"] <= out["run"]["window_steps"]
    assert sp["decode_q"][0] <= sp["decode_q"][-1] <= sp["decode_max"]
    # no kernel on the CPU, no host tables apart from the card
    assert not got & {"k2_roofline", "k2_roofline.itl", "k1_roofline.host",
                      "k1_roofline.hbm", "host_tables_s"}
    out = bench.measure(cell, cfg, w, 2, 3.0, False, "cpu",
                        time.perf_counter())
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert out["metrics"]["itl_p95_ms.chat"] == out["metrics"]["itl_p95_ms"]
