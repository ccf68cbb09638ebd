"""The device trace of a ``--trace 1`` run: one profiler session (CPU and
CUDA activity, input shapes recorded) over the window's last ``seconds``.

The session is a copy of the port's ``chip_smoke.cupti_session``: the
profiler loses the first device records of a session (on an H100 with
torch 2.11: none to 297 of them), so it first runs 1024 throwaway kernels
and then a spin kernel as its marker, and only the device records that
start after the marker count. The raw profiler events are read without
building the profiler's function-event tree (which takes minutes for a
window's millions of events).

``analyse`` reduces the events to what the per-layer readers take:

- the traced window: the ``portbench.window`` annotation's span;
- ``busy_ns``: the union of every kernel, copy and fill interval inside it
  (overlaps counted once);
- ``device_ops``: device time by kernel name, the ten largest;
- ``idle_gaps``: the gaps between device intervals, by what the host was
  doing at each gap's midpoint (the innermost CPU operation on the
  stepping thread, else the harness's annotation), the ten largest;
- ``op_calls[op]``: for each call of a port operator (K1, K2), its input
  shapes and the device time of every kernel launched under it (the
  kernels whose correlation links to a CPU event nested in the call).
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

import torch

PRIME = 1024
WINDOW = "portbench.window"
STEP = "portbench.step"
OPS = ("repro_torch::gated_fuse", "repro_torch::engram_gather")


@dataclasses.dataclass
class Ev:
    name: str
    dev: bool                # a device record (kernel, copy, fill)
    t0: int                  # ns
    t1: int
    tid: int
    corr: int
    linked: int
    shapes: list
    annotation: bool


class Trace:
    """The profiler session of a traced run."""

    def __init__(self, seconds: float, device):
        self.seconds = seconds
        self.device = torch.device(device)
        self.started = False
        self.events = None
        self._cfg = None
        self._acts = None
        self._window = None

    def prepare(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, _prepare_profiler)
        self._cfg = ProfilerConfig(ProfilerState.KINETO, True, False, False,
                                   False, False, _ExperimentalConfig())
        self._acts = {ProfilerActivity.CPU}
        if self.device.type == "cuda":
            self._acts.add(ProfilerActivity.CUDA)
        _prepare_profiler(self._cfg, self._acts)

    def start(self) -> None:
        from torch.autograd import _enable_profiler
        _enable_profiler(self._cfg, self._acts)
        if self.device.type == "cuda":
            x = torch.zeros(1, device=self.device)
            for _ in range(PRIME):
                x.add_(1)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize(self.device)
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.started = True

    def stop(self) -> None:
        from torch.autograd import _disable_profiler
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        res = _disable_profiler()
        self.events = [_ev(e) for e in res.events()]


def _ev(e) -> Ev:
    dev = e.device_type() != torch.autograd.DeviceType.CPU
    t0 = e.start_ns()
    shapes = [] if dev else e.shapes()
    name = e.name()
    # a record_function range shows on the device's timeline too
    # ("gpu_user_annotation"): it is no device work
    annotation = name.startswith("portbench.") or "annotation" in str(
        getattr(e, "activity_type", lambda: "")()) or bool(
        getattr(e, "is_user_annotation", lambda: False)())
    return Ev(name, dev, t0, t0 + e.duration_ns(), e.start_thread_id(),
              e.correlation_id(), e.linked_correlation_id(), shapes,
              annotation)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def analyse(events: list, n_top: int = 10) -> dict:
    dev = [e for e in events if e.dev and not e.annotation]
    host = [e for e in events if not e.dev]
    marks = [e for e in dev if "spin_kernel" in e.name]
    marker_found = len(marks) == 1
    if marks:
        cut = max(e.t1 for e in marks)
        dev = [e for e in dev if e.t0 >= cut]
    wins = [e for e in host if e.name == WINDOW]
    if wins:
        w0, w1 = wins[0].t0, wins[0].t1
    elif dev:
        w0, w1 = min(e.t0 for e in dev), max(e.t1 for e in dev)
    else:
        w0 = w1 = 0
    inside = [e for e in dev if e.t1 > w0 and e.t0 < w1]
    merged = _union((max(e.t0, w0), min(e.t1, w1)) for e in inside)
    busy = sum(b - a for a, b in merged)

    by_name = defaultdict(int)
    for e in inside:
        by_name[e.name] += e.t1 - e.t0
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]

    # what the host did in each idle gap: the stepping thread's innermost
    # operation at the gap's midpoint
    steps = [e for e in host if e.name == STEP]
    tid = steps[0].tid if steps else None
    ops = sorted((e for e in host if e.tid == tid and not e.annotation),
                 key=lambda e: e.t0)
    starts = [e.t0 for e in ops]
    st_sorted = sorted(steps, key=lambda e: e.t0)
    st_starts = [e.t0 for e in st_sorted]

    def label(t: int) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 256, -1), -1):
            if ops[j].t1 >= t:
                return ops[j].name
        k = bisect.bisect_right(st_starts, t) - 1
        if k >= 0 and st_sorted[k].t1 >= t:
            return STEP + " (python between operations)"
        return "harness (outside runtime.step)"

    gaps = defaultdict(int)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[label((a + b) // 2)] += b - a
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:n_top]

    by_link = defaultdict(int)
    for e in dev:
        if e.linked:
            by_link[e.linked] += e.t1 - e.t0
    host_by_tid = defaultdict(list)
    for e in host:
        host_by_tid[e.tid].append(e)
    for v in host_by_tid.values():
        v.sort(key=lambda e: e.t0)
    op_calls = {}
    for name in OPS:
        calls = []
        for e in host:
            if e.name != name or not (w0 <= e.t0 < w1):
                continue
            seq = host_by_tid[e.tid]
            ids = set()
            for j in range(bisect.bisect_left(seq, e.t0, key=_start),
                           len(seq)):
                x = seq[j]
                if x.t0 > e.t1:
                    break
                if x.t1 <= e.t1:
                    ids.add(x.corr)
            calls.append((e.shapes, sum(by_link.get(c, 0) for c in ids)))
        op_calls[name] = calls
    return dict(window_ns=(w0, w1), busy_ns=busy, device_ops=device_ops,
                idle_gaps=idle_gaps, op_calls=op_calls,
                marker_found=marker_found, n_device=len(inside))


def _start(e: Ev) -> int:
    return e.t0
