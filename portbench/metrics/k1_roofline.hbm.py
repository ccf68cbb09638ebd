"""K1 (``csrc/engram_gather.cu``, the ``repro_torch::engram_gather``
operator) over rows in HBM against its roofline, in %: per call, the rows
read from and written to HBM at 3.35 TB/s, summed, over the device time
of the kernels launched under those calls. Cells whose tables lie on the
card."""
from portbench.roofline import flops


def read(run):
    if run.trace is None or run.config["engram"]["placement"] != "device":
        return None
    e = run.config["engram"]
    row = e["emb_dim"] // e["n_heads"] * 2
    calls = run.trace["op_calls"].get("repro_torch::engram_gather", [])
    least = 0.0
    for shapes, _ in calls:
        n = 1
        for s in shapes[-1]:
            n *= s
        least += flops.k1_hbm_least_s(n, row)
    spent = sum(ns for _, ns in calls) / 1e9
    return 100.0 * least / spent if spent > 0 else None
