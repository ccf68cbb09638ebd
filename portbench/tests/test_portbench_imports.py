"""Nothing the harness runs imports JAX, Flax or the JAX package
(``repro``): its sources by their import statements, and a whole run on
the CPU by the modules it loaded (top-level names compared whole:
``repro_torch`` is the program, ``repro`` is not)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    bad = {}
    for p in PORTBENCH.rglob("*.py"):
        hit = _imports(p) & FORBIDDEN
        if hit:
            bad[str(p.relative_to(PORTBENCH))] = sorted(hit)
    assert not bad


SCRIPT = r"""
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
from portbench.harness import bench, cell as cells
from portbench.tests import tiny
cell = cells.Cell("tiny.mix", "mix", 1, tiny.MLA_MOE, tiny.MIX, [], [])
cfg, w = bench.build(cell, "cpu")
out = bench.measure(cell, cfg, w, 3, 1.5, False, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    root = PORTBENCH.parent
    code = SCRIPT.format(src=str(root / "src"), root=str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN
