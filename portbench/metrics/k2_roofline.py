"""K2 (``csrc/gated_fuse.cu``, the ``repro_torch::gated_fuse`` operator)
against its roofline, in %: for every call in the traced window, the
least time (the larger of its bytes over HBM's 3.35 TB/s and its FLOPs
over 989 TFLOP/s, from the call's shapes), summed, over the device time
of every kernel launched under those calls."""
from portbench.roofline import flops


def read(run):
    if run.trace is None:
        return None
    calls = run.trace["op_calls"].get("repro_torch::gated_fuse", [])
    least = sum(flops.k2_least_s(s[0], s[1]) for s, _ in calls)
    spent = sum(ns for _, ns in calls) / 1e9
    return 100.0 * least / spent if spent > 0 else None
