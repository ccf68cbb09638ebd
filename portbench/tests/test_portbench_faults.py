"""A whole run on the CPU at a tiny size (the harness's look for a chip
skipped): sound, it comes out correct; with the timed path broken
underneath, as a server can break, it does not. The control (the
reference in float8 products in the program's place) reads wider gaps
than the program."""
import time

import numpy as np
import pytest

from portbench.harness import bench
from portbench.harness import cell as cells

from . import tiny

E2E = [{"name": n, "unit": "u"}
       for n in ("tokens_per_s", "itl_p95_ms", "setup_s")]


def _run(c, seed=2 ** 31 + 99, control=False, seconds=6.0):
    cell = cells.Cell("tiny.mix", "mix", 1, c, tiny.MIX, E2E, [])
    cfg, w = bench.build(cell, "cpu")
    return bench.measure(cell, cfg, w, seed, seconds, False, "cpu",
                         time.perf_counter(), control=control)


@pytest.mark.parametrize("c", [tiny.DENSE, tiny.MLA_MOE],
                         ids=lambda c: c["name"])
def test_sound_run_is_correct(c):
    out = _run(c)
    assert out["correct"], out["checks"]
    assert out["run"]["checked_tokens"] > 0
    assert set(out["metrics"]) == {"tokens_per_s", "itl_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"


def _altered_tokens(monkeypatch):
    """Every token read back from the device is another token."""
    from repro_torch.serving.engine import Engine
    orig = Engine._host

    def host(self, t):
        a = orig(self, t)
        return (a + 1) % self.cfg.vocab_size if a.size <= self.max_batch \
            else a
    monkeypatch.setattr(Engine, "_host", host)


def _stale_state(monkeypatch):
    """A decode step that returns the state it was given."""
    from repro_torch.models import model as port_model
    orig = port_model._decode_one

    def stale(cfg, flags, params, state, token, rows=None):
        logits, _ = orig(cfg, flags, params, state, token, rows)
        return logits, state
    monkeypatch.setattr(port_model, "_decode_one", stale)


@pytest.mark.parametrize("fault", [_altered_tokens, _stale_state],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("c", [tiny.DENSE, tiny.MLA_MOE],
                         ids=lambda c: c["name"])
def test_broken_path_is_not_correct(c, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(c)
    assert not out["correct"], out["checks"]
    number = c["check"]["number"]
    assert out["checks"][number]["value"] > c["check"]["gap_limit"]
    assert out["failed"] > 0


@pytest.mark.parametrize("c", [tiny.DENSE, tiny.MLA_MOE],
                         ids=lambda c: c["name"])
def test_control_is_not_correct(c):
    """The reference in float8 products, read on the program's prompts and
    tokens, fails the limit the program meets."""
    out = _run(c, control=True)
    number, limit = c["check"]["number"], c["check"]["gap_limit"]
    assert out["run"]["served"][number] <= limit < out["control"][number]
    assert out["correct"] and out["control"]["correct"] is False
    assert np.isfinite(out["control"][number])
