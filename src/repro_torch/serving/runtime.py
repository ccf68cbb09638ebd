"""Request-lifecycle serving runtime over the continuous-batching engine
(PyTorch port of ``repro.serving.runtime``).

The `Engine` started life as an offline harness: `submit()` everything,
then one blocking `run()`. A *pooled* Engram tier, though, is shared
infrastructure — its value shows up under live traffic: admission while
other requests decode, per-request streaming, mid-flight cancellation,
several replicas multiplexing one pool (serving/router.py). This module
is that serving surface:

    rt = EngramRuntime(cfg, pool="CXL", max_batch=8, device="cuda")
    h  = rt.submit([5, 17, 42], max_new=16)       # -> RequestHandle
    for ev in rt.step():                          # one admit + decode wave
        ...                                       #    per-request TokenEvents
    for tok in h.stream():                        # or: iterate the handle —
        ...                                       #    steps the runtime as
    rt.cancel(h)                                  #    needed, yields in order
    stats = rt.drain()                            # run whatever is left

`step()` is one admission pass, one chunk-prefill wave (with
``prefill_chunk`` set) and one decode wave (a speculative verify wave
with ``spec`` set), each emitted token routed to its request's handle.
`Engine.run()` is a thin `drain()` over this.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterator, Optional

from .engine import Engine, EngineStats, Request


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One generated token for one request, in emission order."""
    rid: int
    token: int
    index: int                   # position in the request's output stream
    finished: bool               # this token completes the request
    t_s: float = 0.0             # virtual emission time (serving/clock.py)


class RequestHandle:
    """A submitted request's lifecycle handle: buffered `TokenEvent`s,
    status, and streaming iterators.

    Iterating (`stream()` / `events()` / `for tok in handle`) first drains
    tokens already buffered by earlier `step()` calls — wherever those
    steps came from — and only drives `runtime.step()` itself when the
    buffer is empty and the request is still live, so handle iteration and
    external stepping interleave freely without reordering or duplication.
    """

    def __init__(self, runtime: "EngramRuntime", request: Request):
        self.runtime = runtime
        self.request = request
        self._pending: deque[TokenEvent] = deque()

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def status(self) -> str:
        return self.request.status

    @property
    def finished(self) -> bool:
        return self.request.status == "done"

    @property
    def cancelled(self) -> bool:
        return self.request.status == "cancelled"

    @property
    def tokens(self) -> list:
        """Tokens emitted so far (the completed output once finished)."""
        return list(self.request.out)

    def cancel(self) -> bool:
        return self.runtime.cancel(self)

    def _push(self, ev: TokenEvent) -> None:
        self._pending.append(ev)

    def events(self) -> Iterator[TokenEvent]:
        """Yield this request's `TokenEvent`s in order, stepping the
        runtime when nothing is buffered; ends on completion/cancellation."""
        while True:
            while self._pending:
                yield self._pending.popleft()
            if self.finished or self.cancelled:
                return
            if not self.runtime.engine.busy:
                return            # engine drained without us: defensive stop
            self.runtime.step()

    def stream(self) -> Iterator[int]:
        """Yield raw token ids (see `events()` for the stepping contract)."""
        for ev in self.events():
            yield ev.token

    def __iter__(self) -> Iterator[int]:
        return self.stream()

    def result(self) -> list:
        """Block (stepping the runtime) until done; return the full output."""
        for _ in self.events():
            pass
        return self.tokens


class EngramRuntime:
    """Stepwise serving API over one engine replica.

    Construct from a config (builds the engine: all `Engine` kwargs pass
    through) or wrap an existing engine with `EngramRuntime(engine=...)`.
    One runtime per engine — `Engine.runtime()` caches it, and
    `Engine.run()` is `runtime().drain()`.
    """

    def __init__(self, cfg=None, *, engine: Optional[Engine] = None,
                 **engine_kwargs):
        assert (cfg is None) != (engine is None), \
            "pass exactly one of cfg / engine"
        if engine is None:
            engine = Engine(cfg, **engine_kwargs)
        # one runtime per engine: a second wrapper would drive waves whose
        # events the first runtime's handles never see (silent token loss)
        assert engine._runtime is None, \
            "engine already has a runtime — use engine.runtime()"
        self.engine = engine
        self.handles: dict[int, RequestHandle] = {}
        engine._runtime = self

    # ----------------------------------------------------------- lifecycle

    def submit(self, prompt, max_new: int = 16,
               arrival_s=None, klass: str = "uniform",
               slo: str = "batch") -> RequestHandle:
        """Queue a request; returns its lifecycle handle. Accepts a token
        list or a pre-built `Request` (rid is (re)assigned either way; its
        own ``klass`` and ``slo`` are kept). ``arrival_s``/``klass``/``slo``:
        virtual arrival time, workload class and SLO class (see
        `Engine.submit`)."""
        if isinstance(prompt, Request):
            rid = self.engine.submit(prompt.prompt, prompt.max_new,
                                     arrival_s=arrival_s, klass=prompt.klass,
                                     slo=prompt.slo)
        else:
            rid = self.engine.submit(list(prompt), max_new,
                                     arrival_s=arrival_s, klass=klass,
                                     slo=slo)
        req = self.engine.queue[-1]
        assert req.rid == rid
        h = RequestHandle(self, req)
        self.handles[rid] = h
        return h

    @property
    def now_s(self) -> float:
        """This replica's position on the virtual timeline."""
        return self.engine.cursor.now_s

    def advance_to(self, t_s: float) -> None:
        """Fast-forward an idle replica to a future arrival time."""
        self.engine.cursor.advance_to(t_s)

    def step(self) -> list[TokenEvent]:
        """One serving wave: admit queued requests into free slots, then
        (chunked mode) one chunk-prefill wave over the prefill jobs, then
        one decode (or speculative verify) pass over the live batch.
        Returns every token emitted this step as per-request events, in
        emission order, each stamped with the virtual time of the wave
        that emitted it."""
        eng = self.engine
        t0 = time.perf_counter()
        waves = []
        raw = eng._admit()
        if raw:
            waves.append((raw, eng.cursor.now_s))
        if eng.prefill_chunk is not None:
            raw = eng._chunk_wave()
            if raw:
                waves.append((raw, eng.cursor.now_s))
        raw = eng._spec_wave() if eng.spec is not None \
            else eng._decode_wave()
        if raw:
            waves.append((raw, eng.cursor.now_s))
        eng.stats.wall_s += time.perf_counter() - t0
        eng.stats.v_time_s = eng.cursor.now_s
        events = []
        for raw, t_v in waves:
            for req, emitted, finished, base in raw:
                h = self.handles.get(req.rid)
                for i, tok in enumerate(emitted):
                    last = i == len(emitted) - 1
                    ev = TokenEvent(rid=req.rid, token=tok, index=base + i,
                                    finished=finished and last, t_s=t_v)
                    events.append(ev)
                    req.stamps.append(t_v)
                    if h is not None:
                        h._push(ev)
                if finished:
                    # terminal: drop the registry entry so a long-lived
                    # runtime stays bounded
                    self.handles.pop(req.rid, None)
        return events

    def cancel(self, handle) -> bool:
        """Cancel by handle or rid: dequeue if still queued, else free the
        slot mid-flight (the next admit's scatter-write is the rollback).
        Already-buffered tokens stay readable; no further events arrive."""
        rid = handle.rid if isinstance(handle, RequestHandle) else int(handle)
        ok = self.engine.cancel(rid)
        if ok:
            self.handles.pop(rid, None)
        return ok

    def drain(self) -> EngineStats:
        """Step until the queue is empty and every slot is idle."""
        while self.engine.busy:
            self.step()
        return self.engine.stats

    # ---------------------------------------------------------- passthrough

    @property
    def busy(self) -> bool:
        return self.engine.busy

    @property
    def stats(self) -> EngineStats:
        return self.engine.stats

    @property
    def store(self):
        return self.engine.store

    @property
    def done(self) -> dict:
        return self.engine.done

    @property
    def cancelled(self) -> dict:
        return self.engine.cancelled
