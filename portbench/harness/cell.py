"""A cell of ``BENCHMARK.json`` and the files the harness finds by name.

- ``BENCHMARK.json`` ``workloads``: the cell, ``<config>.<mix>``, names its
  configuration and its traffic mix;
- ``configs`` entry ``file``: the configuration's JSON object;
- ``portbench/traffic/<traffic>.json``: the mix's parameters;
- ``portbench/metrics/<metric>.py``: each metric's reader, a function
  ``read(run)`` that returns a number or None (nothing to read: the metric
  is left out of the result line);
- ``portbench/families/<model_type>.py``: the configuration's family, where
  it has one (``harness/family.py``).

A metric belongs to a cell when its ``workloads`` list names the cell, or
when it has no such list.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    traffic_name: str
    chips: int
    config: dict            # the configuration's JSON object
    traffic: dict           # the mix's JSON object
    end_to_end: list        # BENCHMARK.json metric entries of this cell
    per_layer: list
    root: dataclasses.InitVar[Path] = ROOT   # the checkout of its files
    family: object = dataclasses.field(init=False)   # ``family.of``'s

    def __post_init__(self, root):
        from .family import of      # family.py imports this module
        self.family = of(self.config, root)


def _mine(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(cells: {', '.join(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json")
        .read_text())
    return Cell(name, w["traffic"], int(w["chips"]), config, traffic,
                _mine(bench["end_to_end"], name),
                _mine(bench["per_layer"], name), root)


def load_file(path: Path, kind: str):
    """The module in ``path`` (a file found by name: a metric's reader, a
    family), loaded afresh."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    return load_file(root / "portbench" / "metrics" / f"{metric}.py",
                     "metric").read
