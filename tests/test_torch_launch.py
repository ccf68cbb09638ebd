"""PyTorch port vs the JAX reference: the serving CLI
(``repro_torch.launch.serve``), its examples and where the Engram tables
are placed.

``run_once`` (which serves with ``RunFlags(attn_bf16_scores=True)``, as
the reference's does) on reduced deepseek-7b with the reference's weights
bridged, at the emulated operating point: the reference's streams,
``generated_tokens``, decode steps, ``StoreStats`` field by field and the
emulated stall, bit for bit. ``run_compare``'s three Table 2 variants on
the reference's weights, and their printed lines. ``main`` with
``--device cpu``, and its argument errors. A process that runs the CLI imports nothing of JAX or of the JAX
package. The example twins run on the CPU. ``table_memory_for`` is the one
place the tables' placement comes from."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch.train import reduced_config as ref_reduced_config  # noqa: E402,E501
from repro.models.model import init_params as ref_init_params  # noqa: E402
from repro_torch.examples import serve_pooled, serve_router  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import reduced_config  # noqa: E402
from repro_torch.models.params import (from_jax, init_params,  # noqa: E402
                                       table_memory_for)
from repro_torch.models.transformer import RunFlags  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "deepseek-7b"
# (pool, run_once knobs): a hot-row cache in front of CXL, and RDMA, whose
# fetches outlast the emulated 5e-5 s step (a stall on the clock)
CASES = {"CXL+cache": dict(pool="CXL", cache_rows=2000),
         "RDMA": dict(pool="RDMA")}
RUN_KW = dict(requests=6, max_new=6, max_batch=4, max_len=64,
              emulate_step_s=5e-5)


@pytest.fixture(scope="module")
def bridged():
    rcfg = ref_reduced_config(ARCH)
    rparams = ref_init_params(rcfg, 0)
    cfg = reduced_config(ARCH)
    return cfg, rcfg, rparams, from_jax(jax.tree.map(np.asarray, rparams),
                                        cfg, device="cpu")


def _streams(frontend):
    return [frontend.engine.done[r].out for r in sorted(frontend.engine.done)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_once_matches_reference(bridged, case):
    cfg, rcfg, rparams, params = bridged
    kw = dict(RUN_KW, **CASES[case])
    rfe, rst = ref_serve.run_once(rcfg, params=rparams, **kw)
    fe, st = serve.run_once(cfg, params=params, device="cpu", **kw)
    assert fe.engine.flags.attn_bf16_scores
    assert _streams(fe) == _streams(rfe)
    for f in ("generated_tokens", "decode_steps", "prefills",
              "prefill_waves", "stall_s", "emu_time_s"):
        assert getattr(st, f) == getattr(rst, f), f
    assert st.generated_tokens == 36
    assert dataclasses.asdict(fe.store.stats()) == \
        dataclasses.asdict(rfe.store.stats())
    if case == "RDMA":
        assert st.stall_s > 0                  # the emulated stall


def test_run_compare_matches_reference(bridged, monkeypatch, capsys):
    """Table 2's rows on the reference's weights: each ``run_once`` that
    ``run_compare`` makes in either package is served the reference's draw
    for the config it was handed (the port's bridged), and its frontend
    kept. The variants come in the reference's order, and each variant's
    streams, generated tokens, decode steps, stall and ``StoreStats``
    (None for the baseline, which has no Engram) equal the reference's;
    the printed lines take the same form."""
    cfg, rcfg, rparams, params = bridged
    ref_draw = {False: rparams,
                True: ref_init_params(dataclasses.replace(rcfg, engram=None),
                                      0)}
    draw = {False: params,
            True: from_jax(jax.tree.map(np.asarray, ref_draw[True]),
                           dataclasses.replace(cfg, engram=None),
                           device="cpu")}

    def serving(module, draws, fronts):
        run_once = module.run_once

        def run(c, **kw):
            fe, st = run_once(c, params=draws[c.engram is None], **kw)
            fronts.append((c.engram is None, kw["pool"], fe))
            return fe, st
        monkeypatch.setattr(module, "run_once", run)

    ref_fronts, fronts = [], []
    serving(ref_serve, ref_draw, ref_fronts)
    serving(serve, draw, fronts)
    kw = dict(requests=2, max_new=3, max_batch=2, max_len=32)
    want = ref_serve.run_compare(rcfg, **kw)
    ref_out = capsys.readouterr().out.splitlines()
    got = serve.run_compare(cfg, device="cpu", **kw)
    out = capsys.readouterr().out.splitlines()
    assert [n for n, _ in got] == [n for n, _ in want] == \
        ["baseline", "+Engram (DRAM)", "+Engram (CXL)"]
    assert [f[:2] for f in fronts] == [f[:2] for f in ref_fronts] == \
        [(True, None), (False, "DRAM"), (False, "CXL")]
    for (_, a), (_, b), f, rf in zip(got, want, fronts, ref_fronts):
        assert (a.generated_tokens, a.decode_steps) == \
            (b.generated_tokens, b.decode_steps) == (6, 2)
        assert a.stall_s == b.stall_s
        assert _streams(f[2]) == _streams(rf[2])
        stats = [None if fe.store is None else dataclasses.asdict(
            fe.store.stats()) for fe in (f[2], rf[2])]
        assert stats[0] == stats[1]
        assert (stats[0] is None) == f[0]
    assert [ln[:18] for ln in out] == [ln[:18] for ln in ref_out]
    assert all("decode steps)" in ln for ln in out)


def test_main_serves_on_the_cpu(capsys):
    """The README's CLI line with ``--device cpu``: exit 0, the pool line
    with 6 x 6 tokens, then the store line (a tiered store with an LRU
    hot-row cache)."""
    rc = serve.main(["--arch", ARCH, "--reduced", "--requests", "6",
                     "--max-new", "6", "--max-batch", "4", "--max-len",
                     "64", "--pool", "RDMA", "--cache-rows", "50000",
                     "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[0].startswith("pool=RDMA: 36 tokens in ")
    assert out[1].startswith("store[RDMA]: ") and "@ DRAM" in out[1]


@pytest.mark.parametrize("argv", [
    ["--admission", "tinylfu"],
    ["--pool", "CXL+SSD"],
    ["--compare", "--speculate"],
])
def test_main_argument_errors(argv, capsys):
    """The reference's argument checks: each exits 2 before a model is
    built."""
    with pytest.raises(SystemExit) as e:
        serve.main(["--reduced", "--device", "cpu"] + argv)
    assert e.value.code == 2
    assert "error:" in capsys.readouterr().err


def test_cli_process_imports_nothing_of_jax():
    """``python -m repro_torch.launch.serve --device cpu`` in a fresh
    process: it serves, and neither JAX nor the JAX package is loaded."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['serve', '--arch', 'deepseek-7b', '--reduced', "
        "'--requests', '2', '--max-new', '2', '--max-batch', '2', "
        "'--max-len', '32', '--pool', 'CXL', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.serve', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("pool=CXL: 4 tokens in ")
    assert lines[-1] == "clean"


def test_example_twins_run(capsys):
    """``repro_torch.examples.serve_pooled`` (the Table 2 compare, then one
    pool driven through the runtime's handles) and ``serve_router``
    (streamed and cancelled requests; it asserts the shared cache beats
    private ones) on the CPU."""
    assert serve_pooled.main(["--requests", "2", "--max-new", "2",
                              "--device", "cpu"]) == 0
    assert serve_pooled.main(["--requests", "3", "--max-new", "3",
                              "--pool", "CXL", "--device", "cpu"]) == 0
    assert serve_router.main(["--fast", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "+Engram (CXL)" in out and "pool=CXL: 9 tokens" in out
    assert "shared cache beats private" in out


def test_table_placement_in_one_place(bridged):
    """``table_memory_for``: host memory for ``pooled_host`` (from the flags,
    else the config), the parameters' device for every other strategy;
    on the CPU an engine with ``pooled_host`` draws its own tables (CPU
    tensors) and accepts them, and ``init_params`` at the placement
    for those flags draws the bytes of a plain draw."""
    cfg = bridged[0]
    host = RunFlags(engram_strategy="pooled_host")
    assert table_memory_for(cfg) is None
    assert table_memory_for(cfg, RunFlags()) is None
    assert table_memory_for(cfg, host) == "pinned_host"
    hcfg = dataclasses.replace(
        cfg, engram=dataclasses.replace(cfg.engram, strategy="pooled_host"))
    assert table_memory_for(hcfg) == "pinned_host"
    assert table_memory_for(hcfg, RunFlags(engram_strategy="local")) is None
    assert table_memory_for(dataclasses.replace(cfg, engram=None)) is None
    a = init_params(cfg, 3, "cpu", table_memory=table_memory_for(cfg, host))
    b = init_params(cfg, 3, "cpu")
    for la, lb in zip(a["engram"]["layers"], b["engram"]["layers"]):
        assert la["tables"].device.type == "cpu"
        assert torch.equal(la["tables"], lb["tables"])
    eng = Engine(cfg, flags=host, device="cpu", max_batch=2, max_len=32)
    assert eng.has_engram
