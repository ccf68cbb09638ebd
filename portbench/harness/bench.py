"""One measured run of a cell: set-up, the window, the outputs check, the
metrics and the result line (``run.py`` is the command around it)."""
from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time
from typing import Optional

import torch

from . import cell as cells
from . import check, drive, model
from .trace import Trace, analyse

TRACE_S = 8.0        # the traced part of a --trace 1 window, its last seconds


@dataclasses.dataclass
class Run:
    """What the metric readers read (``portbench/metrics/*.py``)."""
    config: dict
    window: drive.Window
    setup_s: float
    host_tables_s: Optional[float]
    trace: Optional[dict]            # ``trace.analyse``'s, or None
    family: object                   # the cell's family: ``prefill``, ...


def build(cell: cells.Cell, device):
    """The port's config and the weights' storage (host tables mapped)."""
    cfg = cell.family.model_config(cell.config)
    host = cell.config["engram"]["placement"] == "host"
    return cfg, model.Weights(cfg, device, host)


def measure(cell: cells.Cell, cfg, weights, seed: int,
            seconds: float, traced: bool, device, t_start: float,
            control: bool = False) -> dict:
    """One run from the drawn weights to the result line's object.
    ``t_start``: the process's start on ``time.perf_counter``'s clock."""
    c, fam = cell.config, cell.family
    dev = torch.device(device)
    t_draw = time.perf_counter()
    tables_s = weights.draw(seed)
    host_tables_s = None if weights.host_tables_s is None \
        else weights.host_tables_s + tables_s
    t_engine = time.perf_counter()
    eng = model.engine(cfg, fam.run_flags(c), c, weights, dev)
    clients = drive.Clients(eng.runtime(), cell.traffic, cell.traffic_name,
                            seed, cfg.vocab_size)
    tr = Trace(min(seconds, TRACE_S), dev) if traced else None
    t_warm = time.perf_counter()
    win = drive.run(clients, seconds, tr)
    setup_s = win.t_open - t_start
    phases = {"start_to_draw": t_draw - t_start,
              "draw": t_engine - t_draw, "engine": t_warm - t_engine,
              "warmup": win.t_open - t_warm}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # the program's state goes before the reference runs on the card
    del clients, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run = Run(c, win, setup_s, host_tables_s,
              analyse(tr.events) if tr is not None else None, fam)

    chk = c["check"]
    number, limit = chk["number"], chk["gap_limit"]
    picked = check.sample(win.reqs, win.t_close, seed, chk["sample_tokens"],
                          chk["max_requests"])
    t_ref = time.perf_counter()
    ctrl = None
    if not picked:
        served = []
    elif control:
        served, ctrl = check.control_gaps(fam.Reference, c, weights.tree,
                                          picked, dev)
    else:
        served = check.served_gaps(fam.Reference, c, weights.tree, picked,
                                   dev)
    ref_s = time.perf_counter() - t_ref
    got = check.summary(served)
    ok = got[number] is not None and got[number] <= limit
    per_req = [check.summary([g])[number] for g in served]

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cells.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {
        "correct": bool(ok),
        "attempted": len(win.reqs),
        "failed": sum(v > limit for v in per_req) + (0 if picked else 1),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if run.trace is not None:
        t = run.trace
        out["device"]["busy_s"] = t["busy_ns"] / 1e9
        out["device"]["window_s"] = (t["window_ns"][1] - t["window_ns"][0]) \
            / 1e9
        out["breakdown"] = {
            "device_ops": [[n, ns / 1e9] for n, ns in t["device_ops"]],
            "idle_gaps": [[n, ns / 1e9] for n, ns in t["idle_gaps"]]}
    out["run"] = {"seed": seed, "window_steps": len(win.steps),
                  "warmup_steps": win.warmup_steps,
                  "step_ms": step_spread(win.steps),
                  "checked_requests": len(picked),
                  "checked_tokens": sum(len(r.tokens) for r in picked),
                  "reference_s": ref_s, "setup_phases_s": phases,
                  "served": got, "served_by_request": per_req}
    if ctrl is not None:
        # the control's own verdict, by the same number and limit
        cs = check.summary(ctrl)
        cs["correct"] = cs[number] is not None and cs[number] <= limit
        out["control"] = cs
    out["checks"] = {number: {"value": got[number], "limit": limit}}
    return out


def step_spread(steps) -> dict:
    """How the window's host time spreads over its steps (ms), to tell a
    few stalls from a host that is slow all through: the quartiles and
    the longest of the decode-only steps, and the admitting steps' count
    and total."""
    dec = sorted(1e3 * (s.t1 - s.t0) for s in steps
                 if s.decode and not s.prefills)
    adm = [1e3 * (s.t1 - s.t0) for s in steps if s.prefills]
    q = statistics.quantiles(dec, n=4) if len(dec) > 1 else dec
    return {"decode_n": len(dec), "decode_q": q,
            "decode_max": dec[-1] if dec else None,
            "admit_n": len(adm), "admit_total": sum(adm)}


def report_checks(out: dict) -> None:
    """The numbers compared, beside their limits: the last lines on
    standard error."""
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    if "control" in out:
        number = next(iter(out["checks"]))
        print(f"control {number}: {out['control'][number]} (limit "
              f"{out['checks'][number]['limit']}) correct: "
              f"{out['control']['correct']}", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
