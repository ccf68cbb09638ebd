"""The measured run: the clients' closed loop over the port's
``EngramRuntime`` (``submit``, ``step``), every request stamped on the
host clock by the harness.

Warm-up: the clients start one per step (so no admission group holds
every client's prompt at once), and the loop runs until every client's
first request has been admitted. The window then opens for ``seconds`` of
wall time. A request is stamped when its client submits it and, for each
of its tokens, at the end of the ``step()`` that emitted it (a step ends
in the wave's one device read). A step that starts after the window's
close is not run; tokens a step emits after the close lie outside the
window.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from . import loadgen


@dataclasses.dataclass
class Req:
    client: int
    prompt: list
    max_new: int
    t_submit: float
    stamps: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    t_done: Optional[float] = None


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    prefills: int            # requests admitted by the step
    prompt_tokens: int       # their prompt tokens
    decode: int              # decode waves run (0 or 1)
    emitted: int             # tokens emitted


@dataclasses.dataclass
class Window:
    t_open: float
    t_close: float
    steps: list              # the steps run inside the window
    reqs: list               # every request of the run, in submission order
    warmup_steps: int


class Clients:
    """N closed-loop clients submitting through the runtime."""

    def __init__(self, rt, mix: dict, mix_name: str, seed: int, vocab: int):
        self.rt = rt
        self.seed = seed
        self.vocab = vocab
        self.queues = [list(q) for q in loadgen.plan(mix, mix_name)]
        self.by_rid = {}
        self.reqs = []

    def submit(self, client: int) -> None:
        if not self.queues[client]:
            raise RuntimeError(f"client {client} ran out of requests: the "
                               "mix's per_client is too small for the run")
        spec = self.queues[client].pop(0)
        prompt = loadgen.prompt_ids(spec, self.seed, self.vocab)
        req = Req(client, prompt, spec.max_new, time.perf_counter())
        h = self.rt.submit(prompt, max_new=spec.max_new)
        self.by_rid[h.rid] = req
        self.reqs.append(req)

    def step(self):
        """One runtime step; stamps its tokens, resubmits for each client
        whose request finished. Returns the ``Step`` record."""
        st = self.rt.engine.stats
        p0, t0_tok, d0 = st.prefills, st.prefill_tokens, st.decode_steps
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.step"):
            events = self.rt.step()
        t1 = time.perf_counter()
        st = self.rt.engine.stats
        done = []
        for ev in events:
            req = self.by_rid[ev.rid]
            req.stamps.append(t1)
            req.tokens.append(ev.token)
            if ev.finished:
                req.t_done = t1
                done.append(req.client)
        for c in done:
            self.submit(c)
        return Step(t0, t1, st.prefills - p0, st.prefill_tokens - t0_tok,
                    st.decode_steps - d0, len(events))


def run(clients: Clients, seconds: float, trace=None) -> Window:
    """Warm up, then step for ``seconds``. With a ``trace`` (``trace.Trace``)
    the profiler is prepared before the warm-up, started before the first
    step of the window's last ``trace.seconds`` and stopped after the
    window's last step, so that closing it costs the window nothing."""
    eng = clients.rt.engine
    if trace is not None:
        trace.prepare()
    n = len(clients.queues)
    warm = 0
    for c in range(n):
        clients.submit(c)
        clients.step()
        warm += 1
    while eng.queue:
        clients.step()
        warm += 1
    t_open = time.perf_counter()
    t_close = t_open + seconds
    t_trace = t_close - trace.seconds if trace is not None else t_close
    steps = []
    while True:
        now = time.perf_counter()
        if now >= t_close:
            break
        if trace is not None and not trace.started and now >= t_trace:
            trace.start()
        steps.append(clients.step())
    if trace is not None and trace.started:
        trace.stop()
    return Window(t_open, t_close, steps, clients.reqs, warm)
