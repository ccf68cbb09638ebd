"""The program's spans in the harness (``harness/spans.py``): on synthetic
events, the spans' mirrors change nothing ``trace.analyse`` reads, and a
planted kernel and gap are put down to the right span; on a tiny traced
CPU run with spans on, the host-clock numbers read and the device ones do
not, and a ``--trace 0`` run's result line keeps its form."""
import time

import pytest

from portbench.harness import bench, spans
from portbench.harness import cell as cells
from portbench.harness import trace as tr
from portbench.harness.trace import Ev, analyse

from . import tiny


def _ev(name, t0, t1, dev=False, tid=1, corr=0, linked=0, shapes=(),
        annotation=False):
    return Ev(name, dev, t0, t1, tid, corr, linked, list(shapes), annotation)


def _base():
    """A window [0, 1000]: one step; K2's call launches at 352 a kernel
    that runs [420, 500]; an ``aten::mm`` launches at 52 one that runs
    [100, 150]; the step's read [700, 790]."""
    return [
        _ev("portbench.window", 0, 1000, annotation=True),
        _ev("portbench.step", 10, 900, annotation=True),
        _ev("aten::mm", 50, 60, corr=11),
        _ev("cudaLaunchKernel", 52, 58, corr=12),
        _ev("repro_torch::gated_fuse", 300, 400, corr=20,
            shapes=[[8, 5120], [8, 2560], [5120, 5120], [2560, 5120]]),
        _ev("cudaLaunchKernel", 352, 356, corr=13),
        _ev("aten::_local_scalar_dense", 700, 790, corr=14),
        _ev("spin_kernel", -20, -10, dev=True),
        _ev("mm_kernel", 100, 150, dev=True, linked=12),
        _ev("gated_fuse_kernel", 420, 500, dev=True, linked=13),
    ]


def _mirrors():
    """The program's spans around that step: host ranges (annotations, as
    the profiler types ``record_function`` ranges) and their device-side
    ``gpu_user_annotation`` copies."""
    host = [("engine.step", 20, 880), ("engine.decode_wave", 30, 800),
            ("block.attn", 40, 200), ("engram.fuse", 290, 410),
            ("engine.host_read", 690, 795)]
    out = [_ev("repro_torch." + n, a, b, annotation=True)
           for n, a, b in host]
    out += [_ev("repro_torch." + n, a, b, dev=True, annotation=True)
            for n, a, b in (("engine.decode_wave", 100, 500),
                            ("block.attn", 100, 150))]
    return out


def test_mirrors_change_nothing_analyse_reads():
    want, got = analyse(_base()), analyse(_base() + _mirrors())
    for key in ("busy_ns", "window_ns", "device_ops", "idle_gaps",
                "op_calls", "n_device"):
        assert got[key] == want[key], key
    assert want["op_calls"]["repro_torch::gated_fuse"][0][1] == 80


def test_kernels_and_gaps_by_span():
    d = spans.device_numbers(_base() + _mirrors())
    by = dict(d["device_by_span"])
    assert by == {"repro_torch.block.attn": pytest.approx(50e-9),
                  "repro_torch.engram.fuse": pytest.approx(80e-9)}
    # idle: [0, 100] (midpoint 50, in block.attn), [150, 420] (285, in the
    # wave between the mixer and the fusion), [500, 1000] (750, the read)
    idle = dict(d["idle_by_span"])
    assert idle == {"repro_torch.block.attn": pytest.approx(100e-9),
                    "repro_torch.engine.decode_wave": pytest.approx(270e-9),
                    "repro_torch.engine.host_read": pytest.approx(500e-9)}
    assert d["idle_pct.decode_wave"] == pytest.approx(100 * (1 - 130 / 770))
    assert d["idle_pct.prefill_group"] is None
    assert d["attn_ms.decode_wave"] == pytest.approx(50e-6)
    assert len(d["spans_traced"]) == 5


def test_gap_outside_every_span():
    ev = _base() + [_ev("repro_torch.engine.step", 20, 700,
                        annotation=True)]
    idle = dict(spans.device_numbers(ev)["idle_by_span"])
    assert idle[spans.OUTSIDE] == pytest.approx(500e-9)     # [500, 1000]


def _span(name, t0, t1, parent=None, **attrs):
    from repro_torch.trace import Span
    return Span("repro_torch." + name, t0, t1, parent, attrs)


def test_host_numbers():
    ms = 1_000_000
    s = [_span("tables.host_map", 0, 3000 * ms, bytes=1),
         _span("engine.step", 10_000 * ms, 10_130 * ms),             # 1
         _span("engine.admit", 10_000 * ms, 10_001 * ms, 1),
         _span("engine.decode_wave", 10_002 * ms, 10_129 * ms, 1),   # 3
         _span("engine.host_read", 10_100 * ms, 10_129 * ms, 3),
         _span("engine.step", 10_200 * ms, 10_700 * ms),             # 5
         _span("engine.admit", 10_200 * ms, 10_560 * ms, 5),
         _span("engine.prefill_group", 10_200 * ms, 10_560 * ms, 6,
               tokens=1200),
         _span("engine.decode_wave", 10_570 * ms, 10_690 * ms, 5)]
    h = spans.host_numbers(s, 9.0, 11.0)
    assert (h["waves"], h["groups"]) == (1, 1)
    assert h["decode_wave_ms"] == pytest.approx(127.0)
    assert h["decode_read_ms"] == pytest.approx(29.0)
    assert h["decode_dispatch_ms"] == pytest.approx(98.0)
    assert h["prefill_group_ms"] == pytest.approx(300.0)
    assert h["host_map_s"] == pytest.approx(3.0)
    assert spans.host_numbers(s, 10.1, 11.0)["decode_wave_ms"] is None


E2E = [{"name": n, "unit": "u"}
       for n in ("tokens_per_s", "itl_p95_ms", "setup_s")]


def _run(traced: bool, seconds: float = 4.0):
    cell = cells.Cell("tiny.mix", "mix", 1, tiny.DENSE, tiny.MIX, E2E, [])
    cfg, w = bench.build(cell, "cpu")
    return bench.measure(cell, cfg, w, 2 ** 31 + 7, seconds, traced, "cpu",
                         time.perf_counter())


@pytest.fixture
def spans_on():
    from repro_torch import trace
    trace.drain()
    trace.enable(True)
    try:
        yield trace
    finally:
        trace.enable(False)
        trace.drain()


def _shape(d):
    return {k: _shape(v) if isinstance(v, dict) else type(v).__name__
            for k, v in d.items()}


def test_traced_cpu_run_reads_host_numbers_only(spans_on, monkeypatch):
    seen = {}
    start, orig = tr.Trace.start, bench.analyse

    def started(self):
        seen["t_trace"] = time.perf_counter()
        start(self)

    def keep(events):
        seen["events"] = events
        return orig(events)
    monkeypatch.setattr(tr.Trace, "start", started)
    monkeypatch.setattr(bench, "analyse", keep)
    monkeypatch.setattr(bench, "TRACE_S", 2.0)
    t0 = time.perf_counter()
    out = _run(True)
    h = spans.host_numbers(spans_on.drain(), t0, seen["t_trace"])
    for k in ("decode_wave_ms", "decode_dispatch_ms", "decode_read_ms",
              "prefill_group_ms"):
        assert h[k] is not None and h[k] > 0, k
    assert h["decode_dispatch_ms"] + h["decode_read_ms"] == \
        pytest.approx(h["decode_wave_ms"])
    assert h["host_map_s"] is None               # CPU tables: no mapping
    d = spans.device_numbers(seen["events"])
    assert all(v is None for v in d.values()), d
    assert out["correct"]


def test_untraced_line_keeps_its_form(spans_on):
    on = _run(False, 2.0)
    spans_on.enable(False)
    off = _run(False, 2.0)
    assert _shape(on) == _shape(off)
    assert set(on["metrics"]) == set(off["metrics"])
