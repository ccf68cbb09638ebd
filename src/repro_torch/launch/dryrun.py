"""Multi-pod dry run: trace one rank's step of every (arch x shape) cell
on the production meshes and record memory, cost and collective evidence
(PyTorch port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k [--multi-pod] [--unroll] [--moe gather] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference lowers and compiles each cell for 512 fake XLA host
devices. The port runs one process per rank, so it traces one rank:
rank 0 of a world of 256 (``(data=16, model=16)``) or 512 ranks (``(pod=2,
data=16, model=16)``) on ``torch.distributed``'s ``fake`` backend, whose
collectives move nothing, with every tensor fake (``FakeTensorMode``:
shapes, dtypes and a device, nothing allocated, no kernel launched; on
the meta device plain meta tensors, ``launch.specs.fake_mode``).
Rank 0 holds its blocks of the parameters (``models.model.
mesh_logical_axes``; in training ``train_logical_axes``: the reference's
layout, the dense weights split over "model", but for the leaves of
``models.model.WHOLE_LEAVES``, recorded under ``whole_leaves`` with
their bytes), of the optimizer's moments (ZeRO-1: split over "data" as
``train.optimizer.opt_state_axes`` lays them out), of the batch and of
the decode state (``launch.specs.state_axes``, the reference's), and
runs the step the card runs: the train step of ``train.loop.
build_train_step`` (gradients, their sync over the mesh and AdamW), or
``models.model``'s prefill, decode or encoder step. ``roofline.
counting.CountingMode`` counts it.

``device``: ``"cuda"`` (the default) traces the card's path on fake CUDA
tensors, K1 and K2 as their custom operators and the MoE's grouped GEMM
as ``torch._grouped_mm``; it needs a PyTorch built with CUDA (a CPU-only
build cannot index a fake CUDA tensor), not a card. ``"meta"`` traces the
same path on the meta device, where a CPU-only build can (every device
branch of the port tests for the CPU). ``"cpu"`` traces the CPU path
(the kernels' plain versions), where a MoE cell cannot pass: its plain
grouped GEMM reads the group offsets on the host.

The record keeps the reference's keys where the port has a counterpart:
``memory`` (``argument_bytes``: the rank's parameters, optimizer state,
batch and decode state; ``output_bytes``: new storages the step returns;
``temp_bytes`` and ``peak_bytes_est``: from ``counting.LiveBytes``, the
storages alive during the trace), ``cost`` and ``scaled`` (the counting
mode's FLOPs, bytes and collectives; eager execution has no separate
uncounted cost), ``collectives``, ``model_flops``, ``lower_s`` (building
the rank's arguments and the step), ``ok``, ``error``, ``traceback``,
``total_s``. Keys without a counterpart: ``compile_s`` (no compiler; the
trace's time is ``trace_s``), ``hlo_chars``, ``cost.transcendentals`` and
``memory.alias_bytes`` (no HLO; in-place updates write into the
arguments). The port adds ``device``, ``kernel_calls``, ``n_ops``,
``sampled_loops``, ``trace_s``, ``unmirrored``, ``whole_leaves``, ``zero1`` and
``memory.recompute_counted_as_run``: a sampled loop's storages are
counted for the iterations not run (``roofline.counting.LiveBytes``), but
in a train cell with remat the loops the backward recomputes are counted
as run, so that cell's ``peak_bytes_est`` is an estimate whose backward
part may be low.

``cell_rules``' ``kv_seq`` (the reference's flash-decode layout, a GSPMD
sharding of the KV cache's sequence) is applied: the decode state's KV
leaves hold the rank's block of the sequence and decode combines the
ranks' partial softmaxes (``models.attention.split_softmax``: a ``pmax``
and two ``psum`` a layer over the rule's axes). The steps run under
``effective_rules``: ``kv_seq`` cut to the axes the cell's KV leaves
resolve it to after the batch, as the reference's ``spec_for`` does (a
rank's step sees its share of the batch, not the whole). ``unmirrored``
stays in the record, empty. ``zero1=True`` (the reference's ZeRO-1
gradient constraint) is recorded: the port's train step always lays its
gradients and moments out so. ``unroll`` is recorded, and changes
nothing (the port runs layer by layer either way). The recurrent
mixers' scans over positions and chunked attention's loops over KV
blocks run ``LOOP_SAMPLE`` + 1 iterations, scaled to the rest
(``roofline.counting.sample_loops``, ``models.loops.trips``).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from ..configs.base import SHAPES, applicable_shapes, get_config, list_archs
from ..models.model import (abstract_params, build_decode_step,
                            build_encoder_step, build_prefill_step,
                            mesh_logical_axes, train_logical_axes,
                            whole_leaves)
from ..models.params import tree_leaves
from ..models.transformer import RunFlags
from ..roofline.analysis import model_flops
from ..roofline.counting import CountingMode, LiveBytes, sample_loops
from ..sharding.rules import DEFAULT_RULES, ShardCtx, sharding_ctx
from ..train.loop import build_train_step
from ..train.optimizer import AdamWConfig, init_opt_state
from .mesh import make_production_mesh
from .specs import (abstract_decode_state, batch_shardings, fake_mode,
                    input_specs, param_shardings, rank_blocks,
                    state_shardings)

RECORD_VERSION = 2
# the reference's keys that have no counterpart here (module docstring)
NO_COUNTERPART = ("compile_s", "hlo_chars", "cost.transcendentals",
                  "memory.alias_bytes")
# cell rules the port does not mirror: recorded, not applied (none)
UNMIRRORED = ()
# iterations of a sampled loop the trace runs after the first, scaled to
# the rest (``roofline.counting.sample_loops``)
LOOP_SAMPLE = 4


def cell_rules(cfg, shape, mesh, optimized: bool = False) -> dict:
    """Per-cell sharding-rule overrides (the reference's)."""
    rules = {}
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp *= mesh.shape[a]
    if shape.kind == "decode" and shape.global_batch < dp:
        # batch can't fill the data axis: flash-decode (shard KV sequence)
        rules["kv_seq"] = ("data",)
    if optimized and shape.kind == "decode":
        # when kv heads can't fill the model axis (GQA kv<|model| or MLA
        # latent cache), the reference shards the KV cache over `model`
        # via kv_seq
        model = mesh.shape.get("model", 1)
        kv_heads_fill = (cfg.attn_impl != "mla"
                         and cfg.n_kv_heads % model == 0)
        if not kv_heads_fill and "kv_seq" not in rules:
            rules["kv_seq"] = ("model",)
    return rules


def effective_rules(rules: dict, mesh, shape) -> dict:
    """``rules`` as a cell's state resolves them: ``kv_seq`` cut to the
    mesh axes the KV leaves' sequence takes after their batch dim (the
    reference resolves a leaf's dims in order and drops an axis an
    earlier dim took or the length does not divide, so the rule can do
    nothing), and off outside decode (the reference's prefill returns
    its caches without it)."""
    if not rules.get("kv_seq"):
        return dict(rules)
    out = dict(rules)
    out["kv_seq"] = ()
    if shape.kind == "decode":
        ctx = ShardCtx(mesh, {**DEFAULT_RULES, **rules})
        spec = ctx.spec_for((shape.global_batch, shape.seq_len),
                            ("batch", "kv_seq"))
        if len(spec) > 1:
            out["kv_seq"] = (spec[1],) if isinstance(spec[1], str) \
                else tuple(spec[1])
    return out


def build_step(cfg, shape, flags, zero1: bool = False, ctx=None):
    """Returns (fn, kind) for the cell. ``zero1`` (the reference's ZeRO-1
    gradient constraint) changes nothing: the port's sharded train step
    always reduce-scatters its gradients onto the moments' ZeRO-1 layout
    (``train.loop``)."""
    if shape.kind == "train":
        return build_train_step(cfg, flags, AdamWConfig(), ctx=ctx), "train"
    if shape.kind == "prefill":
        if cfg.is_encoder:
            # encoder-only archs: prefill_32k == full bidirectional forward
            return build_encoder_step(cfg, flags), "prefill"
        return build_prefill_step(cfg, flags, max_len=shape.seq_len), "prefill"
    return build_decode_step(cfg, flags), "decode"


def fake_world(n_ranks: int) -> None:
    """This process as rank 0 of ``n_ranks`` on the ``fake`` backend (a
    world of another size is torn down first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n_ranks and dist.get_rank() == 0:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               unroll: bool = False, moe: str = "gather",
               engram_strategy: str | None = None, remat: bool = True,
               rules_extra: dict | None = None,
               flags_extra: dict | None = None, zero1: bool = False,
               optimized: bool = False, device: str = "cuda",
               cfg=None) -> dict:
    """Trace rank 0's step of one cell (module docstring); the record.
    ``cfg``: a config to trace in place of ``arch``'s (a reduced one)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n_dev = dist.get_world_size()
    fx = dict(flags_extra or {})
    if optimized:
        fx.setdefault("attn_bf16_scores", True)
        if shape.kind == "train":
            fx.setdefault("xent_remat", True)
    flags = RunFlags(remat=remat and shape.kind == "train",
                     moe_strategy=moe, engram_strategy=engram_strategy, **fx)
    rec = {
        "version": RECORD_VERSION,
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "axes": list(mesh.axis_names), "n_devices": n_dev,
        "unroll": unroll, "moe": moe,
        "engram_strategy": engram_strategy or
        (cfg.engram.strategy if cfg.engram else None),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "device": device, "zero1": zero1,
    }
    rules = cell_rules(cfg, shape, mesh, optimized=optimized)
    if rules_extra:
        rules.update(rules_extra)
    rec["optimized"] = optimized
    rec["rules"] = {k: list(v) for k, v in rules.items()}
    rec["unmirrored"] = [k for k in rules if k in UNMIRRORED]
    applied = effective_rules({k: v for k, v in rules.items()
                               if k not in UNMIRRORED}, mesh, shape)
    t0 = time.time()
    try:
        with sharding_ctx(mesh, applied) as ctx:
            mode = fake_mode(device)
            step, kind = build_step(cfg, shape, flags, zero1, ctx=ctx)
            specs = input_specs(cfg, shape, device, mode)
            batch = rank_blocks(specs, batch_shardings(specs, ctx), mode,
                                device)
            layout = train_logical_axes(cfg, flags) if kind == "train" \
                else mesh_logical_axes(cfg)
            params = rank_blocks(abstract_params(cfg),
                                 param_shardings(cfg, ctx, layout), mode,
                                 device)
            rec["whole_leaves"] = whole_leaves(cfg, ctx)
            if kind == "train":
                with mode:
                    opt = init_opt_state(params, step.zero)
                args = (params, opt, batch)
            elif kind == "prefill":
                args = (params, batch)
            else:
                whole = abstract_decode_state(cfg, flags, shape.global_batch,
                                              shape.seq_len, device, mode)
                state = rank_blocks(whole, state_shardings(whole, ctx),
                                    mode, device)
                del whole
                args = (params, state, batch["token"])
            mem = LiveBytes()
            for t in tree_leaves(list(args)):
                mem.hold(t)
            arg_bytes = mem.current
            rec["lower_s"] = round(time.time() - t0, 2)
            t1 = time.time()
            counter = CountingMode(memory=mem)
            with mode, counter, sample_loops(counter, LOOP_SAMPLE):
                out = step(*args)
            rec["trace_s"] = round(time.time() - t1, 2)
            out_bytes = mem.current - arg_bytes
            del out
            st = counter.stats()
            rec["memory"] = {
                "argument_bytes": int(arg_bytes),
                "output_bytes": int(out_bytes),
                "temp_bytes": int(mem.peak - arg_bytes - out_bytes),
                "peak_bytes_est": int(mem.peak),
                # a remat period's sampled scans recomputed in the backward
                # hold k + 1 positions' storages, counted as run
                "recompute_counted_as_run": bool(
                    kind == "train" and flags.remat and
                    st["sampled_loops"]),
            }
            rec["cost"] = {"flops": st["flops_dot"],
                           "bytes_accessed": st["bytes_accessed"]}
            rec["collectives"] = st["collectives"]
            rec["scaled"] = {k: st[k] for k in ("flops_dot", "bytes_accessed",
                                                "collectives")}
            rec["kernel_calls"] = st["kernel_calls"]
            rec["n_ops"] = st["n_ops"]
            rec["sampled_loops"] = st["sampled_loops"]
            rec["model_flops"] = model_flops(cfg, shape)
            rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure as data
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=10)
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--unroll", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--moe", default="gather",
                    choices=["dense", "ragged", "gather", "alltoall"])
    ap.add_argument("--engram", default=None,
                    choices=[None, "local", "tp", "pooled"], nargs="?")
    ap.add_argument("--optimized", action="store_true",
                    help="the reference's production flags (bf16 scores, "
                         "xent remat, the kv_seq predicate)")
    ap.add_argument("--device", default="cuda",
                    choices=["cuda", "meta", "cpu"],
                    help="fake tensors on the card's path (cuda, meta) or "
                         "the CPU path")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    assigned = [a for a in list_archs() if not a.startswith("engram-")]
    if args.all:
        cells = [(a, s) for a in assigned
                 for s in applicable_shapes(get_config(a))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for mp in meshes:
        for arch, shp in cells:
            tag = "pod2" if mp else "pod1"
            rec = lower_cell(arch, shp, multi_pod=mp, unroll=args.unroll,
                             moe=args.moe, engram_strategy=args.engram,
                             remat=not args.no_remat,
                             optimized=args.optimized, device=args.device)
            f = outdir / f"{tag}__{arch}__{shp}.json"
            f.write_text(json.dumps(rec, indent=1))
            status = "OK " if rec["ok"] else "FAIL"
            mem = rec.get("memory", {}).get("peak_bytes_est", 0) / 2**30
            coll = rec.get("collectives", {}).get(
                "total_wire_bytes_per_device", 0) / 2**20
            print(f"[{status}] {tag} {arch:22s} {shp:12s} "
                  f"trace={rec.get('trace_s', 0):7.1f}s "
                  f"peak/dev={mem:8.2f}GiB coll={coll:9.1f}MiB"
                  + ("" if rec["ok"] else f"  {rec['error'][:120]}"),
                  flush=True)
            if not rec["ok"]:
                failures += 1
    n = len(cells) * len(meshes)
    print(f"\n{n - failures}/{n} cells passed")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
