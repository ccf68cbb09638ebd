"""K1 (``csrc/engram_gather.cu``, the ``repro_torch::engram_gather``
operator) over rows in host memory against its roofline, in %: per call,
the rows read over PCIe Gen5 x16's nominal 64 GB/s or written over HBM's
3.35 TB/s, the larger, summed, over the device time of the kernels
launched under those calls. Cells whose tables lie in host memory."""
from portbench.roofline import flops


def read(run):
    if run.trace is None or run.config["engram"]["placement"] != "host":
        return None
    e = run.config["engram"]
    row = e["emb_dim"] // e["n_heads"] * 2
    calls = run.trace["op_calls"].get("repro_torch::engram_gather", [])
    least = 0.0
    for shapes, _ in calls:
        gid = shapes[-1]
        n = 1
        for s in gid:
            n *= s
        least += flops.k1_host_least_s(n, row)
    spent = sum(ns for _, ns in calls) / 1e9
    return 100.0 * least / spent if spent > 0 else None
