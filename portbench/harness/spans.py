"""The program's spans (``repro_torch.trace``) in a run: the per-layer
numbers they give, on the host clock and on the device trace's.

The port records a span at each of its layer boundaries once
``repro_torch.trace.enable(True)`` is called, and mirrors each into a
recording profiler session as a ``record_function`` range of the same
name. Every span's name starts with ``repro_torch.`` (the port's custom
operators are ``repro_torch::...``). Two readings:

- **Host clock**, from the drained spans (``repro_torch.trace.drain()``:
  ``Span(name, t0_ns, t1_ns, parent, attrs)`` on ``time.perf_counter``'s
  clock, the harness's): ``host_numbers``, over the part of the window
  before the profiler session started, since a recording profiler slows
  the host.
- **Device trace**, from ``trace.Trace``'s events: the spans' host
  ranges on the trace's own clock and each kernel's launch, linked by
  correlation as ``trace.analyse``'s ``op_calls`` links them:
  ``device_numbers``.

Nothing of this is wired into ``run.py`` yet (``PERF.md``, open
questions, says which files need which edit).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from .trace import WINDOW, _union

PREFIX = "repro_torch."
STEP = PREFIX + "engine.step"
ADMIT_GROUP = PREFIX + "engine.prefill_group"
WAVE = PREFIX + "engine.decode_wave"
READ = PREFIX + "engine.host_read"
ATTN = PREFIX + "block.attn"
HOST_MAP = PREFIX + "tables.host_map"
OUTSIDE = "outside the program's spans"


def is_span(name: str) -> bool:
    return name.startswith(PREFIX)


# --------------------------------------------------------------- host clock

def _children(spans) -> list:
    kids = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s.parent is not None:
            kids[s.parent].append(i)
    return kids


def _waves_alone(spans, t0_ns: int, t1_ns: int) -> list:
    """(wave, host ns of its reads) of each step inside [t0, t1] that ran
    a decode wave and admitted nothing."""
    kids = _children(spans)
    out = []
    for i, s in enumerate(spans):
        if s.name != STEP or s.t0_ns < t0_ns or s.t1_ns > t1_ns:
            continue
        below, stack = [], list(kids[i])
        while stack:
            j = stack.pop()
            below.append(j)
            stack.extend(kids[j])
        if any(spans[j].name == ADMIT_GROUP for j in below):
            continue
        for j in below:
            if spans[j].name == WAVE:
                read = sum(spans[k].t1_ns - spans[k].t0_ns for k in kids[j]
                           if spans[k].name == READ)
                out.append((spans[j], read))
    return out


def host_numbers(spans, t0: float, t1: float) -> dict:
    """The host-clock numbers of the spans inside [t0, t1] (seconds on
    ``time.perf_counter``'s clock); a number with nothing to read is None.

    - ``decode_wave_ms``: the mean ``engine.decode_wave`` of the steps that
      admitted nothing;
    - ``decode_dispatch_ms``: the same waves less their ``engine.host_read``
      children: the host issuing the wave's kernels and its bookkeeping;
    - ``decode_read_ms``: those waves' reads: the host's wait for the
      device after issuing (the two sum to ``decode_wave_ms``);
    - ``prefill_group_ms``: the ``engine.prefill_group`` spans over the
      thousands of useful prompt tokens they admitted (ms per ktok):
      admission without the step's decode wave;
    - ``host_map_s``: every ``tables.host_map`` span of the run, wherever
      it lies (mapping and registering the host tables, at set-up).
    """
    a, b = int(t0 * 1e9), int(t1 * 1e9)
    waves = _waves_alone(spans, a, b)
    groups = [s for s in spans
              if s.name == ADMIT_GROUP and s.t0_ns >= a and s.t1_ns <= b]
    tokens = sum(g.attrs["tokens"] for g in groups)
    maps = [s for s in spans if s.name == HOST_MAP]
    out = {"decode_wave_ms": None, "decode_dispatch_ms": None,
           "decode_read_ms": None, "prefill_group_ms": None,
           "host_map_s": None, "waves": len(waves), "groups": len(groups)}
    if waves:
        n = len(waves)
        wave = sum(w.t1_ns - w.t0_ns for w, _ in waves) / n / 1e6
        read = sum(r for _, r in waves) / n / 1e6
        out.update(decode_wave_ms=wave, decode_read_ms=read,
                   decode_dispatch_ms=wave - read)
    if tokens:
        out["prefill_group_ms"] = sum(g.t1_ns - g.t0_ns for g in groups) \
            / 1e6 / (tokens / 1e3)
    if maps:
        out["host_map_s"] = sum(s.t1_ns - s.t0_ns for s in maps) / 1e9
    return out


# ------------------------------------------------------------- device trace

def _chains(ranges, points) -> list:
    """For each time in sorted ``points``: the names of the ``ranges`` (one
    thread's properly nested spans, sorted by start) open at it,
    outermost first."""
    stack, out, j = [], [], 0
    for t in points:
        while j < len(ranges) and ranges[j].t0 <= t:
            r = ranges[j]
            while stack and stack[-1].t1 < r.t0:
                stack.pop()
            stack.append(r)
            j += 1
        while stack and stack[-1].t1 < t:
            stack.pop()
        out.append(tuple(r.name for r in stack))
    return out


def _busy_in(merged, starts, a: int, b: int) -> int:
    """Device-busy ns of ``merged`` (sorted disjoint intervals, their
    starts in ``starts``) inside [a, b]."""
    busy = 0
    for k in range(max(0, bisect.bisect_right(starts, a) - 1), len(merged)):
        x, y = merged[k]
        if x >= b:
            break
        busy += max(0, min(y, b) - max(x, a))
    return busy


def device_numbers(events, n_top: int = 10) -> dict:
    """The device-trace numbers of a traced run's events
    (``trace.Trace.events``, ``trace.Ev``): the kernels counted and the
    window taken as ``trace.analyse`` takes them (after the session's
    marker, inside the ``portbench.window`` range), the program's spans as
    the host ranges named ``repro_torch.*``. A number with nothing to read
    is None; without device records (a CPU run) every number is.

    - ``spans_traced``: the spans inside the window, (name, t0, t1) on the
      trace's clock;
    - ``device_by_span``: device seconds of the kernels by the innermost
      span around their launch, the ``n_top`` largest;
    - ``idle_by_span``: the idle gaps between device intervals by the
      innermost span on the stepping thread at each gap's midpoint, the
      ``n_top`` largest;
    - ``idle_pct.decode_wave``, ``idle_pct.prefill_group``: 100 x (1 -
      device busy inside the ``engine.decode_wave`` (``prefill_group``)
      spans over their length). A wave or group ends in the engine's one
      device read, so its kernels run inside its host range and the
      device is idle when it opens: idle inside is the phase's own;
    - ``attn_ms.decode_wave``: device ms of the kernels launched under a
      ``block.attn`` span inside a decode wave, per wave.
    """
    dev = [e for e in events
           if e.dev and not e.annotation and not is_span(e.name)]
    marks = [e for e in dev if "spin_kernel" in e.name]
    if marks:
        cut = max(e.t1 for e in marks)
        dev = [e for e in dev if e.t0 >= cut]
    host = [e for e in events if not e.dev]
    wins = [e for e in host if e.name == WINDOW]
    if wins:
        w0, w1 = wins[0].t0, wins[0].t1
    elif dev:
        w0, w1 = min(e.t0 for e in dev), max(e.t1 for e in dev)
    else:
        w0 = w1 = 0
    dev = [e for e in dev if e.t1 > w0 and e.t0 < w1]
    if not dev:
        return dict.fromkeys(("spans_traced", "device_by_span",
                              "idle_by_span", "idle_pct.decode_wave",
                              "idle_pct.prefill_group",
                              "attn_ms.decode_wave"))
    merged = _union((max(e.t0, w0), min(e.t1, w1)) for e in dev)
    starts = [a for a, _ in merged]
    ranges = sorted((e for e in host if is_span(e.name)
                     and e.t0 >= w0 and e.t1 <= w1), key=lambda e: e.t0)
    by_tid = defaultdict(list)
    for r in ranges:
        by_tid[r.tid].append(r)

    # each kernel by the spans open at its launch on the launching thread
    launch = {e.corr: e for e in host if e.corr and not is_span(e.name)}
    per_tid = defaultdict(list)
    for e in dev:
        x = launch.get(e.linked)
        if x is not None:
            per_tid[x.tid].append((x.t0, e.t1 - e.t0))
    device_by = defaultdict(int)
    attn_in_waves = 0
    for tid, ks in per_tid.items():
        ks.sort()
        for (_, ns), chain in zip(ks, _chains(by_tid.get(tid, []),
                                               [t for t, _ in ks])):
            device_by[chain[-1] if chain else OUTSIDE] += ns
            if ATTN in chain and WAVE in chain:
                attn_in_waves += ns

    # idle gaps by the stepping thread's innermost span at their midpoint
    steps = [r for r in ranges if r.name == STEP]
    main = by_tid.get(steps[0].tid, []) if steps else []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle_by = defaultdict(int)
    for (a, b), chain in zip(gaps, _chains(main, [(a + b) // 2
                                                 for a, b in gaps])):
        idle_by[chain[-1] if chain else OUTSIDE] += b - a

    def idle_pct(name):
        spans = [r for r in ranges if r.name == name]
        total = sum(r.t1 - r.t0 for r in spans)
        if not total:
            return None
        busy = sum(_busy_in(merged, starts, r.t0, r.t1) for r in spans)
        return 100.0 * (1.0 - busy / total)

    n_waves = sum(r.name == WAVE for r in ranges)

    def top(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:n_top]]

    return {"spans_traced": [(r.name, r.t0, r.t1) for r in ranges],
            "device_by_span": top(device_by),
            "idle_by_span": top(idle_by),
            "idle_pct.decode_wave": idle_pct(WAVE),
            "idle_pct.prefill_group": idle_pct(ADMIT_GROUP),
            "attn_ms.decode_wave": attn_in_waves / 1e6 / n_waves
            if n_waves else None}
