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
K2 have no backward. Training under a mesh (a sharded train step) is not
ported (ROADMAP item 10b); ``train.ddp`` is the data-parallel step.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs.base import ModelConfig
from ..data import DataConfig, TokenPipeline, frontend_features, shard_batch
from ..device import resolve_device
from ..models.model import abstract_params, build_loss_fn, init_params
from ..models.params import tree_leaves
from ..models.transformer import RunFlags
from ..sharding.rules import current_ctx
from .optimizer import (AdamWConfig, abstract_opt_state, adamw_update,
                        decay_mask, init_opt_state)


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


def value_and_grad(loss_fn, params, batch):
    """(loss, grads): the loss and its gradient with respect to every leaf
    of ``params``, in the tree's structure, each in its leaf's dtype (a
    leaf the loss does not read gets zeros, as ``jax.grad`` gives). The
    parameters are read through detached views that require grad, so the
    caller's tensors keep their flags and carry no graph."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(with_leaves(params, iter(leaves)), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), with_leaves(params, iter(grads))


def build_train_step(cfg: ModelConfig, flags: RunFlags, oc: AdamWConfig,
                     grad_accum: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and moments updated in place (``adamw_update``).

    With ``grad_accum > 1`` the batch's leading dim is split into that
    many microbatches, each one's gradients summed in f32 and the sum
    divided by their count, as are the losses."""
    loss_fn = build_loss_fn(cfg, flags)
    decay = decay_mask(cfg)

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = loss = None
            for i in range(grad_accum):
                micro = {k: v[i * (v.shape[0] // grad_accum):
                              (i + 1) * (v.shape[0] // grad_accum)]
                         for k, v in batch.items()}
                lv, g = value_and_grad(loss_fn, params, micro)
                gl = [x.float() for x in tree_leaves(g)]
                if grads is None:
                    grads, loss = gl, lv
                else:
                    grads = [a.add_(b) for a, b in zip(grads, gl)]
                    loss = loss + lv
            grads = with_leaves(params, (g / grad_accum for g in grads))
            loss = loss / grad_accum
        new_p, new_s, metrics = adamw_update(oc, params, grads, opt_state,
                                             decay)
        metrics["loss"] = loss
        return new_p, new_s, metrics

    return step


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
    device; fresh parameters come from ``init_params(cfg, tc.seed)``."""
    if current_ctx() is not None:
        raise NotImplementedError(
            "training under a mesh (a sharded train step) is not ported: "
            "ROADMAP item 10b; train.ddp.build_ddp_train_step is the "
            "data-parallel step")
    dev = resolve_device(device)
    ckpt = Checkpointer(ckpt_dir, keep_last=tc.keep_ckpts,
                        async_write=tc.async_ckpt) if ckpt_dir else None

    # ----- init or restore ------------------------------------------------
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        ab = abstract_params(cfg)
        tree = ckpt.restore(start_step, {"params": ab,
                                         "opt": abstract_opt_state(ab)}, dev)
        params, opt_state = tree["params"], tree["opt"]
        log(f"[train] restored step {start_step} from {ckpt_dir}")
    else:
        params = init_params(cfg, tc.seed, dev)
        opt_state = init_opt_state(params)

    step_fn = build_train_step(cfg, flags, oc, tc.grad_accum)
    pipe = TokenPipeline(dc)
    fail_at = int(os.environ.get("REPRO_FAIL_AT_STEP", "-1"))

    losses, stragglers, times = [], [], []
    for step in range(start_step, tc.steps):
        b = pipe.batch_at(step)
        b.update(frontend_features(cfg, b["tokens"], dc.seed))
        batch = shard_batch(b, None, dev)
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
                      meta={"loss": loss})
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
                  meta={"loss": losses[-1] if losses else float("nan")})
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
