"""The port's side of tests/test_torch_multidev.py: one process per rank of
a (2, 4) ("data", "model") mesh over gloo, on the CPU.

    start_processes(rank_main, args=(world, init, inputs, out_dir), ...)

Each rank loads the inputs (``torch.save``d whole tensors), takes its
blocks (``sharding.rules``), runs every mesh path of the port under the
mesh, the compressed data-parallel train step on an (8,) mesh and the
elastic checkpoint (saved from an (8,) mesh, restored onto a (2, 4) one),
and saves what it holds to ``out_dir/rank<r>.pt``. It imports nothing of
JAX."""
import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

MESH = ((2, 4), ("data", "model"))


def _engram(ctx, inp, out):
    from repro_torch.core import engram
    from repro_torch.sharding.rules import rank_block
    ecfg, tab = inp["ecfg"], inp["tables"]
    v_pad = engram.padded_vocab(ecfg)
    pool = rank_block(tab, 1, v_pad, ("data", "model"), ctx)
    tp = rank_block(tab, 1, v_pad, ("model",), ctx)
    for case in ("idx", "idx1", "idx_hot"):
        idx = ctx.block(inp[case], ("batch", None, None))
        out[f"tp/{case}"] = engram.retrieve(ecfg, tp, idx, "tp")
        out[f"pooled/{case}"] = engram.retrieve(ecfg, pool, idx, "pooled")
    idx = ctx.block(inp["idx"], ("batch", None, None))
    out["pooled_slack/idx"] = engram.retrieve_pooled(ecfg, pool, idx,
                                                     slack=0.25)
    # whole tables are read in the rank's block: the same rows
    out["pooled_whole/idx"] = engram.retrieve(ecfg, tab, idx, "pooled")


def _moe(ctx, inp, out):
    from repro_torch.models import moe
    params = dict(inp["moe_params"])
    for ax in ("w_gu", "w_down"):
        params[ax] = ctx.block(params[ax], ("experts", None, None))
    for cf in (8.0, 1.0):
        cfg = dataclasses.replace(inp["moe_cfg"], moe=dataclasses.replace(
            inp["moe_cfg"].moe, capacity_factor=cf))
        for strat in ("gather", "alltoall"):
            for case in ("x", "x_odd"):
                x = ctx.block(inp[case], ("batch", None, None))
                o, aux = moe.moe_ffn(cfg, params, x, strategy=strat)
                out[f"moe/{strat}/{cf}/{case}"] = o
                out[f"moe_aux/{strat}/{cf}/{case}"] = aux


def _embed(ctx, inp, out):
    from repro_torch.models.layers import embed_lookup_local
    w = inp["embed_w"]
    toks = ctx.block(inp["embed_toks"], ("batch", None))
    block = {"w": ctx.block(w, ("vocab", None))}
    out["embed/block"] = embed_lookup_local(block, toks, w.shape[0])
    out["embed/whole"] = embed_lookup_local({"w": w}, toks)


def _model(ctx, inp, out, strategy: str):
    """Prefill and greedy decode with ``strategy``'s Engram retrieval,
    alltoall MoE and the vocab-sharded embedding, each rank holding the
    blocks of ``mesh_logical_axes``."""
    from repro_torch.models.model import (build_decode_step,
                                          build_prefill_step,
                                          mesh_logical_axes)
    from repro_torch.models.transformer import RunFlags
    from repro_torch.sharding.rules import local_params
    cfg = inp["model_cfg"]
    params = local_params(inp["model_params"], mesh_logical_axes(cfg), ctx)
    flags = RunFlags(engram_strategy=strategy, moe_strategy="alltoall",
                     embed_local_gather=True)
    toks = ctx.block(inp["model_toks"], ("batch", None))
    steps = inp["decode_steps"]
    logits, state = build_prefill_step(cfg, flags, toks.shape[1] + steps)(
        params, {"tokens": toks})
    decode = build_decode_step(cfg, flags)
    all_logits = [logits]
    for _ in range(steps):
        logits, state = decode(params, state, logits.argmax(-1))
        all_logits.append(logits)
    out[f"model/{strategy}"] = torch.stack(all_logits, dim=1)


DDP_STEPS = 8


def _ddp(inp, out):
    """``build_ddp_train_step`` on an (8,) ("data",) mesh: one step with
    the int8 wire and one exact, from the same weights, then
    ``DDP_STEPS`` compressed steps; the wire collectives' dtypes
    counted."""
    from repro_torch.data import DataConfig, TokenPipeline, shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import tree_map, tree_paths
    from repro_torch.models.transformer import RunFlags
    from repro_torch.train import (AdamWConfig, build_ddp_train_step,
                                   compressed_psum, init_opt_state)
    mesh = make_mesh((8,), ("data",), device="cpu")
    cfg = inp["ddp_cfg"]
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, grad_clip=0.0)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, batch=8,
                                    seq_len=16, seed=0))
    batch = shard_batch(pipe.batch_at(0), device="cpu")
    for name, compress in (("compress", True), ("exact", False)):
        params = tree_map(torch.clone, inp["ddp_params"])
        compressed_psum.wire.clear()
        step = build_ddp_train_step(cfg, RunFlags(), oc, mesh,
                                    compress=compress)
        p, _, m = step(params, init_opt_state(params), batch)
        out[f"ddp/{name}/loss"] = m["loss"]
        out[f"ddp/{name}/params"] = dict(tree_paths(p))
        out[f"ddp/{name}/wire"] = dict(compressed_psum.wire)
    params = tree_map(torch.clone, inp["ddp_params"])
    opt = init_opt_state(params)
    step = build_ddp_train_step(cfg, RunFlags(), oc, mesh)
    losses = []
    for s in range(DDP_STEPS):
        params, opt, m = step(params, opt,
                              shard_batch(pipe.batch_at(s), device="cpu"))
        losses.append(float(m["loss"]))
    out["ddp/losses"] = torch.tensor(losses)


def _elastic(out_dir, out):
    """Save on an (8,) mesh, restore onto a (2, 4) ("x", "y") mesh: the
    ranks of the first hold row blocks of ``w`` and ``b`` and gather them
    whole for rank 0 to write; each rank of the second reads its block
    (``w`` rows over y and columns over x, ``b`` over both)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.rules import sharding_ctx
    whole = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(16)}
    ck = Checkpointer(os.path.join(out_dir, "elastic"), async_write=False)
    mesh_a = make_mesh((8,), ("data",), device="cpu")
    with sharding_ctx(mesh_a) as ctx:
        held = {"w": ctx.block(whole["w"], ("batch", None)),
                "b": ctx.block(whole["b"], ("batch",))}
        gathered = {k: coll.all_gather(v, "data").reshape(whole[k].shape)
                    for k, v in held.items()}
    if dist.get_rank() == 0:
        ck.save(1, gathered)
    dist.barrier()
    mesh_b = make_mesh((2, 4), ("x", "y"), device="cpu")
    with sharding_ctx(mesh_b, rules={"r": ("y",), "c": ("x",),
                                     "rc": ("x", "y")}):
        got = ck.restore(1, whole, "cpu", block={"w": ("r", "c"),
                                                 "b": ("rc",)})
    out["elastic/coords"] = torch.tensor([mesh_b.coords["x"],
                                          mesh_b.coords["y"]])
    out["elastic/w"], out["elastic/b"] = got["w"], got["b"]


def rank_main(rank: int, world: int, init: str, inputs: str, out_dir: str):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import sharding_ctx
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(*MESH, device="cpu")
        inp = torch.load(inputs, weights_only=False)
        out = {"coords": torch.tensor([mesh.coords[a] for a in MESH[1]])}
        with sharding_ctx(mesh) as ctx:
            for part in (_engram, _moe, _embed):
                part(ctx, inp, out)
            _model(ctx, inp, out, "pooled")
        # tp reads the tables row-sharded over the model axis only
        with sharding_ctx(mesh, rules={"eng_vocab": ("model",)}) as ctx:
            _model(ctx, inp, out, "tp")
        _ddp(inp, out)
        _elastic(out_dir, out)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
