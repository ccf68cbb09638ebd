"""Fault-tolerant training loop (PyTorch port of ``repro.train.loop``).

The control plane on top of the train step, as in the reference:

  * grad accumulation over microbatches (a Python loop summing f32
    gradients; the reference's ``lax.scan``),
  * async checkpoint every ``ckpt_every`` steps and restart from the
    latest complete one,
  * deterministic data (batch k is a pure function of (seed, k)), so a
    restart replays the exact stream,
  * failure injection (env ``REPRO_FAIL_AT_STEP``: raises after that step
    commits, before its checkpoint unless it is a checkpoint step),
  * a straggler watchdog: each step's wall clock against the rolling
    median; slow steps are recorded.

The step runs eagerly on the parameters' device (the card unless the
caller passes ``device="cpu"``). Gradients come from autograd through the
plain forward (``models.model.build_loss_fn``), so no kernel runs: K1 and
K2 have no backward. ``train.ddp`` is the data-parallel step.

Under a sharding context (a mesh of ranks, one process each) the step is
sharded: each rank holds its blocks of ``models.model.
train_logical_axes(cfg, flags)`` (the reference's layout: the dense
weights split over "model", the embedding and head over "vocab", the
tables by the retrieval strategy, the routed experts over "experts";
``WHOLE_LEAVES`` whole), takes its block of the batch (split over
``data``, repeated over ``model``), and runs the forward with the mesh's
collectives, whose backwards are their transposes (``sharding.
collectives``: ``psum``'s is ``psum``, as in a ``shard_map`` under
``jax.grad``). The gradients follow one rule:

  each rank back-propagates its local loss divided by the number of
  ranks N, then sums every leaf's gradient over the mesh axes that leaf
  is repeated on (``sync_grads``).

Why it gives the global mean's gradient: rank r's loss L_r is the mean
over its block of the batch, the same on every rank of a data group, so
F = (1/N) sum_r L_r = (1/D) sum_d L_d is the mean over the D data
groups' blocks, the whole batch's mean loss (blocks of equal size).
Read the ranks together as one program in which each rank's copy of a
repeated value is its own variable: F's gradient with respect to a leaf
is the sum over its copies of F's gradient with respect to each copy,
and each collective's transpose carries the cotangents between ranks as
the program's chain rule does. So a value repeated over ``model`` (the
residual stream between two blocks) carries on each rank a share of its
cotangent, and the shares sum to the whole one; every operation's
backward is linear in the cotangent, so shares stay shares. A
column-parallel product needs no collective in either direction: its
input's cotangent on a rank is the share its block of columns gives. A
row-parallel product ends in a ``psum``, whose backward ``psum`` gives
every rank the summed shares, the whole cotangent of the partial
product its block of rows made. ``sync_grads`` then sums the copies:
over every axis for a whole leaf (the norms, the Engram ``proj`` and
``gate``, a leaf the fallback leaves whole), over ``data`` for a leaf
split over ``model`` (the dense blocks, the ``tp`` tables, the experts),
over none for a leaf split over every axis (the ``pooled`` tables, whose
cotangents arrive from every requester through the reverse all_to_all,
duplicates summed by the fan-out's transpose). A rank's batch repeated
over ``model`` is why the 1/N matters: without it each model rank's
identical share would be counted once per rank. (Megatron's pair, an
identity forward with a ``psum`` backward before a column-parallel
product and a ``psum`` forward with an identity backward after a
row-parallel one, computes the same gradients with whole cotangents on
every rank instead of shares; it would need every other collective's
backward, and the 1/N, changed to match.)

ZeRO-1 (``build_train_step``): a leaf's moments are split over ``data``
along the dim ``optimizer.opt_state_axes`` names (``optimizer.
zero_dims``); its gradient's sum over ``data`` is a reduce-scatter onto
that dim (``psum_scatter``), AdamW updates the rank's slice of the leaf,
and the slices are all-gathered over ``data`` back into the block. The
norm sums each leaf's squares over the axes its gradient is split over.
The reference's ``zero1=True`` constrains its gradients to this layout,
the same step.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer
from ..configs.base import ModelConfig
from ..data import DataConfig, TokenPipeline, frontend_features, shard_batch
from ..device import resolve_device
from ..models.model import (abstract_params, build_loss_fn, init_params,
                            train_logical_axes)
from ..models.params import tree_leaves, tree_paths
from ..models.transformer import RunFlags
from ..sharding import collectives as coll
from ..sharding.rules import ShardCtx, current_ctx, split_axes_tree
from .optimizer import (AdamWConfig, abstract_opt_state, adamw_update,
                        decay_mask, init_opt_state, opt_state_axes,
                        with_paths, zero_dims)


class SimulatedFailure(RuntimeError):
    """Injected node failure (REPRO_FAIL_AT_STEP)."""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    grad_accum: int = 1
    log_every: int = 10
    ckpt_every: int = 50
    keep_ckpts: int = 3
    seed: int = 0
    watchdog_factor: float = 3.0     # step > factor x median => straggler
    async_ckpt: bool = True


def with_leaves(tree, leaves):
    """``tree``'s structure (nested dicts and lists) over the next items
    of the iterator ``leaves``, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: with_leaves(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [with_leaves(v, leaves) for v in tree]
    return next(leaves)


def value_and_grad(loss_fn, params, batch, scale: float = 1.0):
    """(loss, grads): the loss and its gradient with respect to every leaf
    of ``params``, in the tree's structure, each in its leaf's dtype (a
    leaf the loss does not read gets zeros, as ``jax.grad`` gives). The
    parameters are read through detached views that require grad, so the
    caller's tensors keep their flags and carry no graph. ``scale``: the
    gradients are those of ``scale`` x the loss (the loss returned as
    it is)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(with_leaves(params, iter(leaves)), batch)
        grads = torch.autograd.grad(loss * scale if scale != 1.0 else loss,
                                    leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), with_leaves(params, iter(grads))


# elements a bucket of ``sync_grads`` gathers into one all_reduce
SYNC_BUCKET = 1 << 24


@torch.no_grad()
def sync_grads(grads, split: dict, ctx: ShardCtx, zero: dict | None = None):
    """Sum every leaf of ``grads`` (this rank's blocks) over the mesh axes
    of more than one rank that the leaf is repeated on (those of ``ctx``'s
    mesh not in ``split[path]``, see ``sharding.rules.split_axes_tree``),
    in place. Leaves sharing axes and dtype go out in buckets of up to
    ``SYNC_BUCKET`` elements (one all_reduce each); a larger leaf goes
    alone. ``zero`` (``optimizer.zero_dims``): the sum of those leaves over
    their ZeRO-1 axes is a reduce-scatter onto their dim, and the leaf
    becomes the rank's slice. Returns ``grads``."""
    mesh = ctx.mesh
    zero = zero or {}
    groups, slices = {}, {}
    for path, g in tree_paths(grads):
        rest = set()
        if path in zero:
            dim, z_axes = zero[path]
            slices[path] = coll.psum_scatter(g, z_axes, dim)
            rest = set(z_axes)
            g = slices[path]
        axes = tuple(a for a in mesh.axis_names if a not in split[path]
                     and a not in rest and mesh.shape[a] > 1)
        if axes:
            groups.setdefault((axes, g.dtype), []).append(g)
    for (axes, _), leaves in groups.items():
        bucket, n = [], 0
        for g in leaves + [None]:
            if g is not None and g.numel() >= SYNC_BUCKET \
                    and g.is_contiguous():
                coll.psum(g, axes)
                continue
            if bucket and (g is None or n + g.numel() > SYNC_BUCKET):
                flat = coll.psum(torch.cat([b.reshape(-1) for b in bucket]),
                                 axes)
                for b, part in zip(bucket, flat.split(
                        [b.numel() for b in bucket])):
                    b.copy_(part.view(b.shape))
                bucket, n = [], 0
            if g is not None:
                bucket.append(g)
                n += g.numel()
    if slices:
        grads = with_paths(grads, lambda path, g: slices.get(path, g))
    return grads


def build_grad_fn(cfg: ModelConfig, flags: RunFlags, grad_accum: int = 1,
                  ctx: Optional[ShardCtx] = None,
                  zero: dict | None = None) -> Callable:
    """(params, batch) -> (loss, grads): the first half of the train step.

    With ``grad_accum > 1`` the batch's leading dim is split into that
    many microbatches, each one's gradients summed in f32 and the sum
    divided by their count, as are the losses.

    With ``ctx`` (a mesh of ranks) it is the sharded step's of the module
    docstring: ``params`` are this rank's blocks of ``train_logical_axes(
    cfg, flags)`` and ``batch`` its block of the batch;
    the microbatches' gradients are summed before ``sync_grads``, so each
    rank returns the global mean loss and its blocks of that loss's
    gradients. Call it under ``sharding_ctx`` of the same mesh.
    ``zero`` (``optimizer.zero_dims``): those leaves' gradients come back
    as the rank's ZeRO-1 slices (``sync_grads``). ``grad_fn.split`` is the
    mesh axes each returned gradient is split over (the layout's
    ``split_axes_tree``, with the ZeRO-1 axes; None without a mesh), what
    ``adamw_update`` takes."""
    loss_fn = build_loss_fn(cfg, flags)
    split, scale = None, 1.0
    if ctx is not None:
        split = split_axes_tree(abstract_params(cfg), train_logical_axes(
            cfg, flags), ctx)
        every = ctx.mesh.axis_names
        scale = 1.0 / ctx.axis_prod(every)
    zero = zero or {}

    def grad_fn(params, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch, scale)
        else:
            grads = loss = None
            for i in range(grad_accum):
                micro = {k: v[i * (v.shape[0] // grad_accum):
                              (i + 1) * (v.shape[0] // grad_accum)]
                         for k, v in batch.items()}
                lv, g = value_and_grad(loss_fn, params, micro, scale)
                gl = [x.float() for x in tree_leaves(g)]
                if grads is None:
                    grads, loss = gl, lv
                else:
                    grads = [a.add_(b) for a, b in zip(grads, gl)]
                    loss = loss + lv
            grads = with_leaves(params, (g / grad_accum for g in grads))
            loss = loss / grad_accum
        if ctx is not None:
            grads = sync_grads(grads, split, ctx, zero)
            loss = coll.psum(loss.clone(), every) * scale
        return loss, grads

    if split is not None:
        for path, (_, z_axes) in zero.items():
            split[path] = tuple(a for a in ctx.mesh.axis_names
                                if a in split[path] or a in z_axes)
    grad_fn.split = split
    return grad_fn


def build_train_step(cfg: ModelConfig, flags: RunFlags, oc: AdamWConfig,
                     grad_accum: int = 1,
                     ctx: Optional[ShardCtx] = None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and moments updated in place (``adamw_update``): the
    gradients of ``build_grad_fn`` (its ``grad_accum`` and ``ctx``), then
    AdamW, under a mesh with the norm taken over the blocks and ZeRO-1's
    moments (module docstring): ``opt_state`` holds the rank's slices,
    ``init_opt_state(params, step.zero)``. Without a mesh,
    ``metrics["loss"]`` is the batch's mean loss; with one, the global
    mean."""
    zero = {} if ctx is None else zero_dims(
        abstract_params(cfg), train_logical_axes(cfg, flags), ctx)
    grad_fn = build_grad_fn(cfg, flags, grad_accum, ctx, zero)
    decay = decay_mask(cfg)

    def step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        view = with_paths(params, lambda path, p: _zero_slice(
            p, zero.get(path), ctx))
        _, new_s, metrics = adamw_update(oc, view, grads, opt_state, decay,
                                         grad_fn.split)
        views = dict(tree_paths(view))
        with torch.no_grad():
            for path, p in tree_paths(params):
                if path in zero:
                    dim, axes = zero[path]
                    got = coll.all_gather(views[path], axes)
                    p.copy_(got.movedim(0, dim).flatten(dim, dim + 1))
        metrics["loss"] = loss
        return params, new_s, metrics

    step.zero = zero
    return step


def _zero_slice(p, at, ctx):
    """The rank's ZeRO-1 slice of the block ``p`` (``at`` = (dim, axes) of
    ``optimizer.zero_dims``, None: the whole block), a view."""
    if at is None:
        return p
    dim, axes = at
    n = p.shape[dim] // ctx.axis_prod(axes)
    return p.narrow(dim, ctx.mesh.index(axes) * n, n)


@dataclasses.dataclass
class TrainResult:
    losses: list
    steps_run: int
    restarts: int
    stragglers: list
    final_step: int


def train(cfg: ModelConfig, tc: TrainConfig, dc: DataConfig,
          *, flags: RunFlags = RunFlags(), oc: AdamWConfig = AdamWConfig(),
          ckpt_dir: Optional[str] = None, restarts: int = 0,
          log: Callable[[str], None] = print, device=None) -> TrainResult:
    """Run (or resume from ``ckpt_dir``'s latest complete checkpoint)
    training on ``device``. Deterministic given (cfg, tc, dc) on one
    device; fresh parameters come from ``init_params(cfg, tc.seed)``.

    Under a sharding context every rank of its mesh calls this: fresh
    parameters are the same seeded draw, of which the rank keeps its
    blocks of ``train_logical_axes`` as storage of their own (each whole
    leaf freed once its block is taken), and a restore reads the rank's
    blocks (``Checkpointer.restore(block=)``); each batch is sharded
    (``shard_batch(b, ctx)``), the step is the sharded one
    (``build_train_step(ctx=)``), checkpoints are gathered whole and
    written by rank 0, and the watchdog times each rank's own steps."""
    ctx = current_ctx()
    dev = resolve_device(device)
    ckpt = Checkpointer(ckpt_dir, keep_last=tc.keep_ckpts,
                        async_write=tc.async_ckpt) if ckpt_dir else None
    ab = abstract_params(cfg)
    like = {"params": ab, "opt": abstract_opt_state(ab)}
    layout = None
    if ctx is not None:
        axes = train_logical_axes(cfg, flags)
        layout = {"params": axes, "opt": opt_state_axes(axes)}
        if ckpt is not None:
            # rank 0's last write is on disk before any rank looks
            dist.barrier()

    # ----- init or restore ------------------------------------------------
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        tree = ckpt.restore(start_step, like, dev, block=layout)
        params, opt_state = tree["params"], tree["opt"]
        log(f"[train] restored step {start_step} from {ckpt_dir}")
    else:
        params = init_params(cfg, tc.seed, dev,
                             block=layout and layout["params"])
        opt_state = None
    if ctx is not None and dev.type == "cuda":
        torch.cuda.empty_cache()       # the whole leaves, for the ranks

    step_fn = build_train_step(cfg, flags, oc, tc.grad_accum, ctx)
    if opt_state is None:
        opt_state = init_opt_state(params, step_fn.zero)
    save_kw = {} if ctx is None else dict(block=layout, like=like)
    pipe = TokenPipeline(dc)
    fail_at = int(os.environ.get("REPRO_FAIL_AT_STEP", "-1"))

    losses, stragglers, times = [], [], []
    for step in range(start_step, tc.steps):
        b = pipe.batch_at(step)
        b.update(frontend_features(cfg, b["tokens"], dc.seed))
        batch = shard_batch(b, ctx, dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)

        # straggler watchdog
        times.append(dt)
        if len(times) >= 8:
            med = float(np.median(times[-32:]))
            if dt > tc.watchdog_factor * med:
                stragglers.append((step, dt, med))
                log(f"[watchdog] straggler at step {step}: "
                    f"{dt * 1e3:.1f}ms vs median {med * 1e3:.1f}ms")

        if ckpt is not None and (step + 1) % tc.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      meta={"loss": loss}, **save_kw)
        if (step + 1) % tc.log_every == 0:
            log(f"[train] step {step + 1}/{tc.steps} "
                f"loss={loss:.4f} {dt * 1e3:.0f}ms/step")

        if fail_at == step + 1:
            # crash after the step, mid-interval (checkpoint may be stale)
            if ckpt is not None:
                ckpt.wait()
            raise SimulatedFailure(f"injected failure at step {step + 1}")

    if ckpt is not None:
        ckpt.save(tc.steps, {"params": params, "opt": opt_state},
                  meta={"loss": losses[-1] if losses else float("nan")},
                  **save_kw)
        ckpt.wait()
    return TrainResult(losses=losses, steps_run=tc.steps - start_step,
                       restarts=restarts, stragglers=stragglers,
                       final_step=tc.steps)


def train_with_restarts(cfg: ModelConfig, tc: TrainConfig, dc: DataConfig,
                        *, max_restarts: int = 3, ckpt_dir: str,
                        **kw) -> TrainResult:
    """Supervisor: restart after (injected or real) failures, resuming from
    the latest complete checkpoint, the single-process analogue of a
    cluster controller rescheduling a pod that died."""
    restarts = 0
    while True:
        try:
            return train(cfg, tc, dc, ckpt_dir=ckpt_dir, restarts=restarts,
                         **kw)
        except SimulatedFailure:
            restarts += 1
            os.environ.pop("REPRO_FAIL_AT_STEP", None)  # fail once
            if restarts > max_restarts:
                raise
