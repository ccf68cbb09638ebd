"""SLO classes + overload policy: the fleet's survival contract.

`bench_load.py` proves the paper's headline for a fleet that never says
no: every arrival is admitted, every admitted request keeps its slot until
it finishes. Under a burst that is the collapse mode — interactive p99
TTFT grows without bound behind a wall of batch work. Real fleets survive
by *classifying* traffic and spending three levers per class:

  * **admission control** — bounded per-class queues; an over-cap batch
    request is deferred (held in the router's backlog, its arrival stamp
    preserved so the deferral shows up in its TTFT), an over-cap
    interactive request is shed outright (a deadline that cannot survive
    queueing is better refused than missed late);
  * **priority dispatch** — free slots go to the highest-priority class
    first, deadline order (arrival + TTFT target) within a class;
  * **preemption** — a running batch slot can be preempted for a queued
    interactive request: its KV pages out to the pooled tier
    (`pool/kvpool.py`) and the request resumes later, bit-identical.

An `SLOSpec` names a class and its targets; an `OverloadPolicy` bundles
the class table with the admission/preemption knobs and is the single
object threaded through `serve() -> Router -> Engine`. No policy
(``slo_policy=None``, the default everywhere) keeps every legacy path
bit-exact — the overload machinery is strictly additive.

A verbatim copy of ``repro.serving.slo``: the PyTorch port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One traffic class's service-level objective.

    ``ttft_s``: virtual arrival -> first token target (the attainment
    metric `ServeResult.slo_attainment` scores against). ``itl_s``:
    inter-token gap target (informational; surfaced by the bench).
    ``priority``: dispatch rank — higher wins free slots and may preempt
    strictly-lower-priority running slots."""
    name: str
    ttft_s: float
    itl_s: float = 0.0
    priority: int = 0


# Default class table at the emulated operating point (EMULATED_STEP_S =
# 2e-4 s decode waves — benchmarks/bench_load.py): interactive wants its
# first token within ~a dozen waves, batch tolerates two orders more.
DEFAULT_SLOS: dict[str, SLOSpec] = {
    "interactive": SLOSpec("interactive", ttft_s=3e-3, itl_s=1e-3,
                           priority=10),
    "batch": SLOSpec("batch", ttft_s=200e-3, priority=0),
}


@dataclasses.dataclass
class OverloadPolicy:
    """Admission + preemption knobs for an SLO-classed fleet.

    ``slos``: class table (defaults to `DEFAULT_SLOS`); unknown classes
    resolve to a zero-priority spec with ``default_ttft_s``.
    ``queue_cap``: fleet-wide bound on queued-but-unadmitted requests per
    class (0 = unbounded); ``queue_cap_by_class`` overrides it per class.
    Over the cap, classes in ``defer_classes`` back-pressure into the
    router's backlog; every other class is shed.
    ``preempt``: allow the engine to preempt running lower-priority slots
    for queued higher-priority work, spilling KV to the pool
    (``spill_pool_bytes`` capacity, paged at ``spill_page_tokens`` tokens
    per page — the fixed-size block unit charged on the pool link)."""
    slos: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_SLOS))
    queue_cap: int = 0
    queue_cap_by_class: dict = dataclasses.field(default_factory=dict)
    defer_classes: tuple = ("batch",)
    default_ttft_s: float = 200e-3
    preempt: bool = True
    spill_pool_bytes: int = 64 << 20
    spill_page_tokens: int = 8

    def spec(self, name: str) -> SLOSpec:
        s = self.slos.get(name)
        if s is None:
            s = SLOSpec(name, ttft_s=self.default_ttft_s, priority=0)
        return s

    def priority(self, name: str) -> int:
        return self.spec(name).priority

    def deadline_v(self, req) -> float:
        """A request's virtual deadline: arrival + its class TTFT target
        (the within-class dispatch order)."""
        return req.submitted_v + self.spec(req.slo).ttft_s

    def cap(self, name: str) -> int:
        return int(self.queue_cap_by_class.get(name, self.queue_cap))

    def defers(self, name: str) -> bool:
        """Over-cap behaviour: True -> back-pressure (router backlog),
        False -> shed."""
        return name in self.defer_classes
