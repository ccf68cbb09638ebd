"""The port's side of tests/test_torch_multidev.py: one process per rank of
a (2, 4) ("data", "model") mesh over gloo, on the CPU.

    start_processes(rank_main, args=(world, init, inputs, out_dir), ...)

Each rank loads the inputs (``torch.save``d whole tensors), takes its
blocks (``sharding.rules``: the reference's layout), runs every mesh path
of the port under the mesh, the layout models' forwards, the compressed
data-parallel train step on an (8,) mesh and the elastic checkpoint
(saved from an (8,) mesh, restored onto a (2, 4) one), the sharded train
steps (gradients gathered whole), each differentiable
collective's gradient, the embedding's, and the mesh trainer (a crash
and restart; its checkpoint restored onto an (8,) mesh), and saves what
it holds to ``out_dir/rank<r>.pt``. Then ranks 0 and 1 run the training
CLI on a (1, 2) mesh of their own. ``kv_seq_main`` is
tests/test_torch_kv_seq.py's rank (reduced models under a ``kv_seq``
rule). It imports nothing of JAX."""
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


LAYOUT_FLAGS = dict(engram_strategy="pooled", moe_strategy="alltoall")


def _layout(ctx, inp, out):
    """Each layout model's prefill and greedy decode on the rank's blocks
    of ``mesh_logical_axes`` (the reference's layout), with the shapes of
    its parameter blocks and of its decode state's blocks after the
    prefill, and the leaves its blocks do not gather back into."""
    from repro_torch.models.model import (build_decode_step,
                                          build_prefill_step,
                                          mesh_logical_axes)
    from repro_torch.models.params import tree_paths
    from repro_torch.models.transformer import RunFlags
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.rules import local_params
    for arch in inp["layout_archs"]:
        cfg = inp[f"layout_cfg/{arch}"]
        params = local_params(inp[f"layout_params/{arch}"],
                              mesh_logical_axes(cfg), ctx)
        flags = RunFlags(**LAYOUT_FLAGS)
        toks = ctx.block(inp[f"layout_toks/{arch}"], ("batch", None))
        steps = inp["decode_steps"]
        logits, state = build_prefill_step(cfg, flags, toks.shape[1] + steps)(
            params, {"tokens": toks})
        out[f"layout_state/{arch}"] = {k: tuple(t.shape)
                                       for k, t in tree_paths(state)}
        out[f"layout_params/{arch}"] = {k: tuple(t.shape)
                                        for k, t in tree_paths(params)}
        # the blocks gathered whole (a checkpoint's save), fused parts
        # put back in order
        whole = dict(tree_paths(inp[f"layout_params/{arch}"]))
        axes = dict(tree_paths(mesh_logical_axes(cfg),
                               is_leaf=lambda x: isinstance(x, tuple)))
        out[f"layout_gather/{arch}"] = [
            k for k, t in tree_paths(params) if not torch.equal(
                coll.gather_block(t, tuple(whole[k].shape), axes[k]),
                whole[k])]
        decode = build_decode_step(cfg, flags)
        all_logits = [logits]
        for _ in range(steps):
            logits, state = decode(params, state, logits.argmax(-1))
            all_logits.append(logits)
        out[f"layout/{arch}"] = torch.stack(all_logits, dim=1)


# tests/test_torch_kv_seq.py's cases: name -> (arch, batch, prompt
# length, kv_seq's mesh axes, decode_window_slice); each decodes
# KV_SEQ_STEPS greedy steps past its prompt into a cache of prompt +
# KV_SEQ_STEPS positions, a multiple of the axes' ranks
KV_SEQ_CASES = {
    "deepseek-7b": ("deepseek-7b", 2, 8, ("model",), False),
    "gemma3-1b": ("gemma3-1b", 2, 20, ("model",), False),
    "gemma3-1b-slice": ("gemma3-1b", 2, 20, ("model",), True),
    "deepseek-v2-236b": ("deepseek-v2-236b", 2, 8, ("model",), False),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b", 1, 8, ("data",),
                             False),
}
KV_SEQ_STEPS = 4


def _kv_seq(mesh, inp, out):
    """Each ``KV_SEQ_CASES`` model's prefill and greedy decode on the
    rank's blocks under its ``kv_seq`` rule, with its decode state's block
    shapes after the prefill and after the last step."""
    from repro_torch.models.model import (build_decode_step,
                                          build_prefill_step,
                                          mesh_logical_axes)
    from repro_torch.models.params import tree_paths
    from repro_torch.models.transformer import RunFlags
    from repro_torch.sharding.rules import local_params, sharding_ctx
    for name, (arch, _, _, axes, window_slice) in KV_SEQ_CASES.items():
        cfg = inp[f"kv_seq_cfg/{name}"]
        flags = RunFlags(decode_window_slice=window_slice, **LAYOUT_FLAGS)
        with sharding_ctx(mesh, {"kv_seq": axes}) as ctx:
            params = local_params(inp[f"kv_seq_params/{arch}"],
                                  mesh_logical_axes(cfg), ctx)
            toks = ctx.block(inp[f"kv_seq_toks/{name}"], ("batch", None))
            logits, state = build_prefill_step(
                cfg, flags, toks.shape[1] + KV_SEQ_STEPS)(
                    params, {"tokens": toks})
            out[f"kv_seq_state/{name}/prefill"] = {
                k: tuple(t.shape) for k, t in tree_paths(state)}
            decode = build_decode_step(cfg, flags)
            all_logits = [logits]
            for _ in range(KV_SEQ_STEPS):
                logits, state = decode(params, state, logits.argmax(-1))
                all_logits.append(logits)
            out[f"kv_seq_state/{name}/decode"] = {
                k: tuple(t.shape) for k, t in tree_paths(state)}
            out[f"kv_seq/{name}"] = torch.stack(all_logits, dim=1)
            if name == KV_SEQ_CHUNKED:
                out[f"kv_seq_chunked/{name}"] = _kv_seq_chunked(
                    dataclasses.replace(cfg, engram=None), flags,
                    {k: v for k, v in params.items() if k != "engram"},
                    toks)


# the case whose prompt is also admitted by chunked prefill from an empty
# state, then decoded by one multi-token verify step, without its Engram
# layer (pooled's owners drop requests past their capacity, so a prompt's
# rows depend on how its requests are grouped: ROADMAP F13)
KV_SEQ_CHUNKED = "deepseek-7b"


def _kv_seq_chunked(cfg, flags, params, toks):
    """Under the current ``kv_seq`` rule: the monolithic prefill and
    KV_SEQ_STEPS greedy steps (B, 1 + KV_SEQ_STEPS, V), and ``toks``
    admitted in chunks of 4 (``build_chunk_prefill``) into
    ``init_decode_state``'s blocks, then the greedy stream's tokens fed
    as one block (``build_multitoken_decode``): the chunked prefill's
    logits and the block's, stacked the same way."""
    from repro_torch.models.model import (build_chunk_prefill,
                                          build_decode_step,
                                          build_multitoken_decode,
                                          build_prefill_step,
                                          init_decode_state)
    B, S = toks.shape
    logits, state = build_prefill_step(cfg, flags, S + KV_SEQ_STEPS)(
        params, {"tokens": toks})
    decode = build_decode_step(cfg, flags)
    steps = [logits]
    for _ in range(KV_SEQ_STEPS):
        logits, state = decode(params, state, logits.argmax(-1))
        steps.append(logits)
    state = init_decode_state(cfg, flags, B, S + KV_SEQ_STEPS, "cpu")
    chunk = build_chunk_prefill(cfg, flags)
    for c in range(0, S, 4):
        logits, state = chunk(params, state, toks[:, c:c + 4],
                              torch.full((B,), min(4, S - c)))
    block = torch.stack([t.argmax(-1) for t in steps[:-1]], dim=1)
    verify, _, _ = build_multitoken_decode(cfg, flags)(params, state, block)
    return {"monolithic": torch.stack(steps, dim=1),
            "chunked": torch.cat([logits[:, None], verify], dim=1)}


def kv_seq_main(rank: int, world: int, init: str, inputs: str,
                out_dir: str):
    """tests/test_torch_kv_seq.py's rank: ``_kv_seq`` on the (2, 4) mesh,
    saved to ``out_dir/rank<r>.pt``."""
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(*MESH, device="cpu")
        out = {"coords": torch.tensor([mesh.coords[a] for a in MESH[1]])}
        _kv_seq(mesh, torch.load(inputs, weights_only=False), out)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


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


TRAIN_LR = 1e-4
# (collective, the axes it runs over, the input's shape): each rank's input
# and cotangent are f64 draws seeded by (rank, case)
COLL_CASES = (("all_to_all", ("data", "model"), (8, 3)),
              ("psum", ("data", "model"), (3, 4)),
              ("pmean", ("data", "model"), (3, 4)),
              ("psum_scatter", ("model",), (3, 8)),
              ("all_gather", ("data", "model"), (2, 3)),
              ("gather_dim", ("data", "model"), (3, 2)))


def coll_draw(rank: int, case: int, shape, out_shape):
    """(input, cotangent) of ``rank`` for case ``case``."""
    gen = torch.Generator().manual_seed(1000 * rank + case)
    return (torch.randn(shape, generator=gen, dtype=torch.float64),
            torch.randn(out_shape, generator=gen, dtype=torch.float64))


def coll_out_shape(name: str, n: int, shape):
    """The output shape of collective ``name`` over ``n`` ranks."""
    if name == "psum_scatter":
        return (shape[0], shape[1] // n)
    if name == "all_gather":
        return (n,) + tuple(shape)
    if name == "gather_dim":
        return (shape[0], shape[1] * n)
    return tuple(shape)


def _collective_grads(ctx, out):
    """Each collective on an f64 input that requires grad: the gradient of
    <its output, the rank's cotangent>, for the test to hold against the
    same sum computed whole on one process."""
    from repro_torch.sharding import collectives as coll
    for i, (name, axes, shape) in enumerate(COLL_CASES):
        n = ctx.axis_prod(axes)
        x, cot = coll_draw(dist.get_rank(), i, shape,
                           coll_out_shape(name, n, shape))
        x.requires_grad_()
        fn = getattr(coll, name)
        y = fn(x, axes, 1) if name in ("psum_scatter", "gather_dim") \
            else fn(x, axes)
        (g,) = torch.autograd.grad((y * cot).sum(), x)
        out[f"coll/{name}"] = g


def _gathered(tree, axes, like):
    """path -> the whole leaf, gathered from every rank's block."""
    from repro_torch.models.params import tree_paths
    from repro_torch.sharding import collectives as coll
    ax = dict(tree_paths(axes, is_leaf=lambda x: isinstance(x, tuple)))
    whole = dict(tree_paths(like))
    with torch.no_grad():
        return {k: coll.gather_block(v, tuple(whole[k].shape), ax[k]).clone()
                for k, v in tree_paths(tree)}


def _train_blocks(ctx, cfg, params, flags):
    from repro_torch.models.model import train_logical_axes
    from repro_torch.models.params import tree_map
    from repro_torch.sharding.rules import local_params
    axes = train_logical_axes(cfg, flags)
    return axes, tree_map(lambda t: t.clone(), local_params(params, axes,
                                                            ctx))


def _batch(cfg, ctx):
    from repro_torch.data import DataConfig, TokenPipeline, shard_batch
    return shard_batch(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, batch=4, seq_len=16, seed=0)).batch_at(0),
        ctx, "cpu")


def _train_step(ctx, inp, out, strategy: str):
    """check_tp_train_step's model on the rank's blocks: the global loss
    and every gradient (``build_grad_fn``), then one ``build_train_step``
    step at lr ``TRAIN_LR``: its loss, grad_norm and parameters."""
    from repro_torch.models.model import abstract_params
    from repro_torch.models.params import tree_paths
    from repro_torch.models.transformer import RunFlags
    from repro_torch.train import (AdamWConfig, build_grad_fn,
                                   build_train_step, init_opt_state,
                                   opt_state_axes)
    cfg = inp["tr_cfg"]
    flags = RunFlags(engram_strategy=strategy)
    axes, params = _train_blocks(ctx, cfg, inp["tr_params"], flags)
    batch, like = _batch(cfg, ctx), abstract_params(cfg)
    loss, grads = build_grad_fn(cfg, flags, ctx=ctx)(params, batch)
    out[f"tr/{strategy}/loss"] = loss
    out[f"tr/{strategy}/grads"] = _gathered(grads, axes, like)
    step = build_train_step(cfg, flags, AdamWConfig(lr=TRAIN_LR,
                                                    warmup_steps=1), ctx=ctx)
    p, opt, m = step(params, init_opt_state(params, step.zero), batch)
    out[f"tr/{strategy}/step_loss"] = m["loss"]
    out[f"tr/{strategy}/gnorm"] = m["grad_norm"]
    out[f"tr/{strategy}/params"] = _gathered(p, axes, like)
    mom_axes = opt_state_axes(axes)
    for mom in ("m", "v"):
        out[f"tr/{strategy}/{mom}"] = _gathered(opt[mom], mom_axes[mom],
                                                like)
        out[f"tr/{strategy}/{mom}_shapes"] = {
            k: tuple(t.shape) for k, t in tree_paths(opt[mom])}


def _ep_step(ctx, inp, out):
    """Reduced deepseek-v2-236b's expert-parallel gradients, gather and
    alltoall: at capacity factor 1.25 (rows dropped), and with the
    capacity raised and the load-balance loss off (``ep_cfg_raised``)."""
    from repro_torch.models.model import abstract_params
    from repro_torch.models.transformer import RunFlags
    from repro_torch.train import build_grad_fn
    for case in ("ep_cfg", "ep_cfg_raised"):
        cfg = inp[case]
        for strat in ("gather", "alltoall"):
            flags = RunFlags(moe_strategy=strat)
            axes, params = _train_blocks(ctx, cfg, inp["ep_params"], flags)
            loss, grads = build_grad_fn(cfg, flags, ctx=ctx)(
                params, _batch(cfg, ctx))
            out[f"{case}/{strat}/loss"] = loss
            out[f"{case}/{strat}/grads"] = _gathered(
                grads, axes, abstract_params(cfg))


def _remat_backward_off_thread(ctx, inp, out):
    """Reduced deepseek-v2-236b's expert-parallel loss with remat on, its
    backward run on another thread (the autograd engine runs a CUDA
    graph's backward on its device thread, which does not inherit the
    mesh's thread-local context, yet recomputes the checkpointed periods
    there), against the same backward on this thread."""
    import threading
    from repro_torch.models.model import build_loss_fn
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import RunFlags
    from repro_torch.train.loop import with_leaves
    cfg = inp["ep_cfg_raised"]
    flags = RunFlags(remat=True, moe_strategy="gather")
    _, params = _train_blocks(ctx, cfg, inp["ep_params"], flags)
    batch = _batch(cfg, ctx)
    got = {}
    for where in ("here", "thread"):
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = build_loss_fn(cfg, flags)(with_leaves(params, iter(leaves)),
                                         batch)

        def back(loss=loss, leaves=leaves, where=where):
            try:
                got[where] = torch.autograd.grad(loss, leaves,
                                                 allow_unused=True)
            except Exception as e:           # noqa: BLE001 (reported)
                got[where] = e

        if where == "here":
            back()
        else:
            t = threading.Thread(target=back)
            t.start()
            t.join()
    if isinstance(got["thread"], Exception):
        out["remat_thread"] = [repr(got["thread"])]
        return
    out["remat_thread"] = [torch.equal(a, b) if a is not None else b is None
                           for a, b in zip(got["here"], got["thread"])]


def _embed_grad(ctx, inp, out):
    """``embed_lookup_local``'s gradient from the rank's block of the
    (4096, 64) table: the rank back-propagates <its rows, its cotangent>
    / 8 and ``sync_grads`` sums the block over the data axis; the blocks
    gathered whole."""
    from repro_torch.models.layers import embed_lookup_local
    from repro_torch.sharding import collectives as coll
    from repro_torch.train import sync_grads
    w = inp["embed_w"]
    blk = ctx.block(w, ("vocab", None)).clone().requires_grad_()
    toks = ctx.block(inp["embed_toks"], ("batch", None))
    cot = ctx.block(inp["embed_cot"], ("batch", None, None))
    rows = embed_lookup_local({"w": blk}, toks, w.shape[0])
    (g,) = torch.autograd.grad((rows * cot).sum() / 8, blk)
    g = sync_grads({"w": g}, {"w": ctx.split_axes(tuple(w.shape),
                                                  ("vocab", None))}, ctx)
    out["embed_grad"] = coll.gather_block(g["w"], tuple(w.shape),
                                          ("vocab", None))


def _trainer(ctx, inp, out, out_dir):
    """The mesh trainer on check_tp_train_step's model (pooled): 4 steps
    with a checkpoint every 2, uninterrupted, and crashed after step 3
    (``REPRO_FAIL_AT_STEP``) then restarted from step 2's checkpoint;
    the final checkpoint then restored onto an (8,) ("data",) mesh."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import abstract_params, train_logical_axes
    from repro_torch.models.transformer import RunFlags
    from repro_torch.sharding.rules import sharding_ctx
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   abstract_opt_state, opt_state_axes,
                                   train, train_with_restarts)
    cfg = inp["tr_cfg"]
    tc = TrainConfig(steps=4, ckpt_every=2, log_every=100)
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=16, seed=0)
    kw = dict(flags=RunFlags(engram_strategy="pooled"),
              oc=AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=4),
              log=lambda s: None, device="cpu")
    whole = train(cfg, tc, dc, ckpt_dir=os.path.join(out_dir, "whole"), **kw)
    os.environ["REPRO_FAIL_AT_STEP"] = "3"
    res = train_with_restarts(cfg, tc, dc,
                              ckpt_dir=os.path.join(out_dir, "crash"), **kw)
    out["trainer/whole"] = torch.tensor(whole.losses)
    out["trainer/crash"] = torch.tensor(res.losses)
    out["trainer/restarts"] = res.restarts
    mesh8 = make_mesh((8,), ("data",), device="cpu")
    ab = abstract_params(cfg)
    axes = train_logical_axes(cfg, kw["flags"])
    with sharding_ctx(mesh8):
        got = Checkpointer(os.path.join(out_dir, "crash")).restore(
            4, {"params": ab, "opt": abstract_opt_state(ab)}, "cpu",
            block={"params": axes, "opt": opt_state_axes(axes)})
    out["trainer/restored8"] = got["params"]
    out["trainer/index8"] = mesh8.index(("data",))


def _cli(rank: int, out_dir: str):
    """``launch.train.main`` on a (1, 2) mesh of ranks 0 and 1 (a fresh
    process group, ``file://`` rendezvous; tp retrieval), rank 0 writing
    the metrics."""
    from repro_torch.launch import train as train_cli
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
    train_cli.main(["--arch", "engram-27b", "--reduced", "--mesh",
                    "data=1,model=2", "--engram", "tp", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--device", "cpu",
                    "--metrics-out", os.path.join(out_dir, "cli.json")],
                   init_method=f"file://{os.path.join(out_dir, 'cli_rdzv')}")


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
        out = {"coords": torch.tensor([mesh.coords[a] for a in MESH[1]]),
               "out_dir": out_dir}
        with sharding_ctx(mesh) as ctx:
            for part in (_engram, _moe, _embed):
                part(ctx, inp, out)
            _model(ctx, inp, out, "pooled")
            _layout(ctx, inp, out)
            _collective_grads(ctx, out)
            _embed_grad(ctx, inp, out)
            for strategy in ("pooled", "tp"):
                _train_step(ctx, inp, out, strategy)
            _ep_step(ctx, inp, out)
            _remat_backward_off_thread(ctx, inp, out)
            _trainer(ctx, inp, out, out_dir)
        # tp reads the tables row-sharded over the model axis only
        with sharding_ctx(mesh, rules={"eng_vocab": ("model",)}) as ctx:
            _model(ctx, inp, out, "tp")
        _ddp(inp, out)
        _elastic(out_dir, out)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    if rank < 2:
        _cli(rank, out_dir)
