"""Fleet-wide virtual clock: one event timeline for every time-bearing layer.

Before this subsystem the repo had three disconnected notions of time:
serving steps (workload pacing), host wall seconds (engine stats), and the
emulated operating point (``emulate_step_s``). Arrivals were counted in
steps, N replicas sharing one hot-row cache enjoyed free parallelism, and
the analytic simulator kept its own stall arithmetic. The paper's headline
— *near-DRAM end-to-end performance under real serving load* — is a claim
about a loaded timeline: tier bandwidth **contention under concurrency**,
not unloaded latency, is what separates CXL from RDMA at scale (Table 3's
switch behaviour). This module is that timeline:

  * ``VirtualClock`` — the fleet's event clock. It owns per-resource
    ``Link`` ledgers and one ``Cursor`` per engine replica.
  * ``Cursor``       — a replica's position on the shared timeline. Each
    serving wave advances its cursor by (step compute + charged stall);
    an idle replica fast-forwards to the next arrival.
  * ``Link``         — a shared bandwidth budget (one memory tier, one
    hot-row cache's DRAM channel). A wave *reserves* its transfer's
    occupancy: if another replica's transfer is still in flight the
    reservation queues behind it and the wait is added to the wave's
    latency — N concurrent readers of one resource pay a bandwidth-split
    latency instead of free parallelism.

Link semantics
--------------
``reserve(now_s, service_s, wave=...)`` books ``service_s`` of link
occupancy starting at ``max(now_s, free_at)`` and returns the queueing
delay plus a ``Transfer`` token. Reservations carrying the same ``wave``
tag (one engine wave's per-layer fetches) share a start point — they are
one batched access whose internal parallelism the tier model already
prices — so a *single* replica charges exactly what the uncontended tier
model says (wait 0), and contention appears only across replicas/waves.

Queueing discipline: the busy *horizon* (``free_at_s``, refunds, byte
ledger) is work-conserving FIFO — total booked occupancy is what it
always was. The *wait* returned to a contended reader, however, is
processor-sharing (fair queueing): concurrent owners (distinct replicas,
identified by the first element of their wave tags) split the link
capacity equally, so a short transfer fair-shares past a long one
instead of serialising behind it — the interleaved-DMA behaviour of a
real switch port. A reservation that meets only its *own* backlog (same
owner, or untagged ``wave=None`` bookings, which are serial by
definition) takes the exact FIFO path, so single-reader charges are
bit-identical to the pre-fair-queueing model.

``refund(transfer)`` releases a still-queued reservation — the mid-flight
``cancel()`` path returns the bandwidth a cancelled request's speculative
prefetch had booked.

At the emulated operating point (``Engine(emulate_step_s=...)``)
everything here is deterministic: virtual time is derived from the step
model and the tier/contention arithmetic, never from host wall clocks,
so TTFT/latency percentiles in ``benchmarks/bench_load.py`` are exactly
reproducible. Real-mode engines still carry cursors (the stamps mirror
wall time) but do NOT register contention links: replica cursors are
then wall-skewed (jit compiles, serialized host execution), and charging
queueing across them would double-count what the host already
serializes.

A verbatim copy of ``repro.serving.clock``: the PyTorch port imports
nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Transfer:
    """One booked link occupancy (returned by ``Link.reserve``)."""
    link: "Link"
    start_s: float
    service_s: float
    nbytes: int = 0
    wave: object = None
    refunded: bool = False
    klass: Optional[str] = None      # traffic class ("engram" | "kv" | ...)

    @property
    def end_s(self) -> float:
        return self.start_s + self.service_s


class Cursor:
    """One replica's position on the shared timeline."""

    def __init__(self, name: str):
        self.name = name
        self.now_s = 0.0
        self.waves = 0

    def advance(self, dt_s: float) -> float:
        assert dt_s >= 0.0, dt_s
        self.now_s += dt_s
        return self.now_s

    def advance_to(self, t_s: float) -> float:
        """Fast-forward (idle replica meeting a future arrival); never
        moves backwards."""
        self.now_s = max(self.now_s, float(t_s))
        return self.now_s

    def wave_tag(self) -> tuple:
        """Tag for this wave's link reservations (see ``Link.reserve``):
        stable within a wave, distinct across waves."""
        return (self.name, self.waves)

    def next_wave(self) -> None:
        self.waves += 1

    def __repr__(self) -> str:
        return f"Cursor({self.name!r}, now={self.now_s:.6f}s)"


def _owner(wave: object):
    """Owner identity of a wave tag: ``Cursor.wave_tag()`` is
    ``(replica_name, wave_no)`` — the replica is the flow, successive
    waves of one replica are serial. Untagged bookings own nothing."""
    if isinstance(wave, tuple) and wave:
        return wave[0]
    return None


class Link:
    """A shared bandwidth resource on the virtual timeline.

    Occupancy ledger is single-queue and work-conserving: a reservation's
    booked slot starts when the link is free, runs for its service time,
    and pushes the ``free_at_s`` horizon out — refunds, byte totals and
    busy time are untouched by the queueing discipline. Same-``wave``
    reservations share their start point and *accumulate* occupancy (one
    batched access; its internal concurrency is already in the tier's
    service model).

    The *wait* charged to a contended reservation is processor-sharing:
    live flows (one per owner — see ``_owner``) split the link equally,
    each finishing when its remaining bytes drain at the fair rate. A
    reservation whose only backlog belongs to itself (same owner or
    untagged) keeps the exact FIFO wait, so single-reader charges stay
    bit-identical to the historical single-queue model; equal-service
    two-reader waits are also unchanged (the fair share of an equal peer
    equals serialising behind it). Divergence appears exactly where it
    should: unequal transfers under multi-owner contention.
    """

    def __init__(self, name: str, bandwidth_Bps: float = 0.0):
        self.name = name
        self.bandwidth_Bps = bandwidth_Bps
        self.free_at_s = 0.0
        # measured accounting
        self.reservations = 0
        self.busy_s = 0.0
        self.wait_s = 0.0
        self.contended = 0            # reservations that had to queue
        self.bytes_total = 0
        # per-traffic-class occupancy (KV pages vs Engram rows sharing one
        # medium — the arbitration observable); untagged bookings are not
        # classed, so legacy ledgers are byte-identical
        self.bytes_by_class: dict = {}
        self.busy_s_by_class: dict = {}
        self.refunds = 0
        self.refunded_s = 0.0
        self._last_wave: object = None
        self._last_start: float = 0.0
        self._last_wait: float = 0.0
        # live flow ledger for fair queueing: [owner, start_s, end_s]
        # per cross-wave reservation (same-wave siblings extend the tail
        # entry); pruned against ``now`` on every cross-wave reserve.
        self._flows: list[list] = []

    @staticmethod
    def _ps_wait(own_s: float, others: dict, service_s: float) -> float:
        """Processor-sharing completion wait for a newcomer with
        ``own_s`` of serial backlog and ``service_s`` of new work,
        against competing owners with ``others[owner]`` remaining work
        each. All live flows drain at rate 1/n (n = live flows); a flow
        exits when its remaining work is done, raising everyone's rate.
        Returns completion time minus service (the queueing delay)."""
        virtual = own_s + service_s         # the newcomer's flow length
        t = 0.0
        drained = 0.0
        n = len(others) + 1
        for r in sorted(others.values()):
            if r >= virtual:
                break                        # newcomer finishes first
            t += (r - drained) * n
            drained = r
            n -= 1
        t += (virtual - drained) * n
        return max(0.0, t - service_s)

    def reserve(self, now_s: float, service_s: float, nbytes: int = 0,
                wave: object = None, klass: Optional[str] = None
                ) -> tuple[float, Transfer]:
        """Book ``service_s`` of occupancy; -> (queue wait, transfer).
        ``klass`` (optional) attributes the booking to a traffic class in
        the per-class ledgers (``bytes_by_class``/``busy_s_by_class``)."""
        service_s = max(0.0, float(service_s))
        now = float(now_s)
        if wave is not None and wave == self._last_wave:
            start = self._last_start          # same wave: parallel access
            self.free_at_s = max(self.free_at_s, start) + service_s
            if self._flows:
                self._flows[-1][2] = self.free_at_s
            else:
                self._flows.append([_owner(wave), start, self.free_at_s])
            wait = self._last_wait            # the wave queued once
        else:
            start = max(now, self.free_at_s)
            wait = start - now                # FIFO wait (exact ledger)
            owner = _owner(wave)
            if self._flows:
                self._flows = [f for f in self._flows if f[2] > now]
            if owner is not None and self._flows:
                own_s = 0.0
                others: dict = {}
                for o, st, en in self._flows:
                    rem = en - max(now, st)
                    if o is None or o == owner:
                        own_s += rem          # serial with the newcomer
                    else:
                        others[o] = others.get(o, 0.0) + rem
                if others:
                    wait = self._ps_wait(own_s, others, service_s)
            self._last_wave = wave
            self._last_start = start
            self._last_wait = wait
            self.free_at_s = start + service_s
            self._flows.append([owner, start, self.free_at_s])
        tr = Transfer(link=self, start_s=start, service_s=service_s,
                      nbytes=int(nbytes), wave=wave, klass=klass)
        self.reservations += 1
        self.busy_s += service_s
        self.wait_s += wait
        self.contended += int(wait > 0.0)
        self.bytes_total += int(nbytes)
        if klass is not None:
            self.bytes_by_class[klass] = \
                self.bytes_by_class.get(klass, 0) + int(nbytes)
            self.busy_s_by_class[klass] = \
                self.busy_s_by_class.get(klass, 0.0) + service_s
        return wait, tr

    def refund(self, tr: Transfer) -> bool:
        """Release a booked reservation (cancelled speculative prefetch).

        The busy horizon rolls back ONLY when the transfer is still the
        link's tail — if another reservation queued behind it in the
        meantime, rolling back would let the next booking overlap that
        still-occupying transfer (double-booked bandwidth). A non-tail
        refund is recorded in the stats but leaves the horizon alone:
        conservatively over-counting one wave's occupancy beats
        under-counting contention for every wave after a cancel."""
        if tr.refunded or tr.link is not self:
            return False
        tr.refunded = True
        if self.free_at_s == tr.end_s:              # still the tail
            self.free_at_s = tr.start_s
            self.busy_s -= tr.service_s
            self.bytes_total -= tr.nbytes
            if tr.klass is not None:
                self.bytes_by_class[tr.klass] = \
                    self.bytes_by_class.get(tr.klass, 0) - tr.nbytes
                self.busy_s_by_class[tr.klass] = \
                    self.busy_s_by_class.get(tr.klass, 0.0) - tr.service_s
            self._last_wave = None                  # start point is gone
            for i in range(len(self._flows) - 1, -1, -1):
                if self._flows[i][2] == tr.end_s:   # shrink the tail flow
                    self._flows[i][2] = tr.start_s
                    if self._flows[i][2] <= self._flows[i][1]:
                        del self._flows[i]
                    break
        self.refunds += 1
        self.refunded_s += tr.service_s
        return True

    def stats(self) -> dict:
        out = {"name": self.name, "reservations": self.reservations,
               "busy_s": self.busy_s, "wait_s": self.wait_s,
               "contended": self.contended, "bytes": self.bytes_total,
               "refunds": self.refunds, "refunded_s": self.refunded_s}
        if self.bytes_by_class:
            out["bytes_by_class"] = dict(self.bytes_by_class)
            out["busy_s_by_class"] = dict(self.busy_s_by_class)
        return out


class VirtualClock:
    """The fleet's event timeline: cursors (replica positions) + links
    (shared bandwidth ledgers). One clock per serving fleet — the router
    hands the same instance to every replica, so their stores' link
    reservations interleave on one timeline."""

    def __init__(self):
        self.cursors: dict[str, Cursor] = {}
        self.links: dict[str, Link] = {}
        self.refunded_bytes = 0
        self.refunded_s = 0.0

    def cursor(self, name: str) -> Cursor:
        c = self.cursors.get(name)
        if c is None:
            c = self.cursors[name] = Cursor(name)
        return c

    def link(self, name: str, bandwidth_Bps: float = 0.0) -> Link:
        ln = self.links.get(name)
        if ln is None:
            ln = self.links[name] = Link(name, bandwidth_Bps)
        return ln

    def refund(self, tr: Optional[Transfer]) -> bool:
        """Refund a reservation through its link, with clock-level
        accounting (the cancel test's observable)."""
        if tr is None:
            return False
        nb, sv = tr.nbytes, tr.service_s
        ok = tr.link.refund(tr)
        if ok:
            self.refunded_bytes += nb
            self.refunded_s += sv
        return ok

    @property
    def now_s(self) -> float:
        """Fleet horizon: the furthest replica's position."""
        return max((c.now_s for c in self.cursors.values()), default=0.0)

    def stats(self) -> dict:
        return {
            "now_s": self.now_s,
            "cursors": {n: c.now_s for n, c in self.cursors.items()},
            "links": {n: ln.stats() for n, ln in self.links.items()},
            "refunded_bytes": self.refunded_bytes,
            "refunded_s": self.refunded_s,
        }
