"""Nothing the harness runs imports JAX, Flax or the JAX package
(``repro``): its sources by their import statements, the family files
under ``families/`` with them, and a whole run on the CPU by the modules
it loaded, with and without a family (top-level names compared whole:
``repro_torch`` is the program, ``repro`` is not). A reference, the
harness's own (``reference/``) or a family's (``families/``), takes
nothing of the program that computes: of ``repro_torch`` only the
configuration classes a mapping builds and the engine's flags."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCES = ("reference", "families")
PORT_ALLOWED = ("repro_torch.configs",
                "repro_torch.models.transformer.RunFlags")


def _imports(path: Path) -> set:
    """Every name the file imports, dotted in full (``from a import b``:
    ``a.b``)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out |= {f"{node.module}.{a.name}" for a in node.names}
    return out


def _takes_of_the_port(name: str) -> bool:
    return name.split(".")[0] == "repro_torch" and not any(
        name == a or name.startswith(a + ".") for a in PORT_ALLOWED)


def _bad_sources(portbench: Path) -> dict:
    bad = {}
    for p in portbench.rglob("*.py"):
        rel = p.relative_to(portbench)
        names = _imports(p)
        hit = {n.split(".")[0] for n in names} & FORBIDDEN
        if rel.parts[0] in REFERENCES:
            hit |= {n for n in names if _takes_of_the_port(n)}
        if hit:
            bad[str(rel)] = sorted(hit)
    return bad


def test_no_source_imports_jax_or_the_jax_package(tmp_path):
    assert not _bad_sources(PORTBENCH)
    # a family file, loaded by path at run time and imported by no module,
    # is scanned with the rest
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "x.py").write_text(
        "import jax.numpy as jnp\nfrom repro.models import model\n")
    assert _bad_sources(tmp_path) == {"families/x.py": ["jax", "repro"]}


def test_a_reference_takes_nothing_of_the_port_that_computes(tmp_path):
    """A reference that ran the program's kernels, forward or engine would
    compare the program with itself."""
    for d in ("families", "reference", "harness"):
        (tmp_path / d).mkdir()
    (tmp_path / "families" / "ok.py").write_text(
        "from repro_torch.configs.base import MLAConfig, ModelConfig\n"
        "from repro_torch.models.transformer import RunFlags\n"
        "from portbench.harness import model\n")
    (tmp_path / "families" / "x.py").write_text(
        "from repro_torch import kernels\nimport repro_torch.serving\n"
        "def f():\n    from repro_torch.models.moe import moe_ffn\n")
    (tmp_path / "reference" / "y.py").write_text(
        "from repro_torch.models import transformer\nimport repro_torch\n")
    # the harness drives the program: it may take what it needs of it
    (tmp_path / "harness" / "z.py").write_text(
        "from repro_torch.serving import Engine\n")
    assert _bad_sources(tmp_path) == {
        "families/x.py": ["repro_torch.kernels", "repro_torch.models.moe."
                          "moe_ffn", "repro_torch.serving"],
        "reference/y.py": ["repro_torch", "repro_torch.models.transformer"]}


SCRIPT = r"""
import json, pathlib, sys, time
sys.path[:0] = [{src!r}, {root!r}]
from portbench.harness import bench, cell as cells
from portbench.tests import tiny
if {family!r}:
    c, root = tiny.FAMILY_CONFIG, pathlib.Path({family!r})
    tiny.write_family(root)
else:
    c, root = tiny.MLA_MOE, cells.ROOT
cell = cells.Cell("tiny.mix", "mix", 1, c, tiny.MIX, [], [], root)
cfg, w = bench.build(cell, "cpu")
out = bench.measure(cell, cfg, w, 3, 1.5, False, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("with_family", [False, True])
def test_a_run_loads_no_jax(with_family, tmp_path):
    root = PORTBENCH.parent
    code = SCRIPT.format(src=str(root / "src"), root=str(root),
                         family=str(tmp_path) if with_family else "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN
    if with_family:
        log = tmp_path / "portbench" / "families" / "tiny_mla_moe.log"
        assert "model_config" in log.read_text().splitlines()
