"""Pure data-parallel train step with compressed gradient sync (PyTorch
port of ``repro.train.ddp``).

Each rank holds the whole model and optimizer state (replicated) and its
block of the batch along the data-parallel axis. Forward and backward run
locally; the gradients are then averaged over that axis by the
int8-compressed all-reduce (``train.compress``) or an exact mean, and
every rank applies the same AdamW update, so the replicas stay equal.
"""
from __future__ import annotations

from typing import Callable

from ..configs.base import ModelConfig
from ..models.model import build_loss_fn
from ..models.params import tree_map
from ..models.transformer import RunFlags
from ..sharding import collectives as coll
from ..sharding.rules import Mesh, sharding_ctx
from .compress import compressed_pmean_tree
from .loop import value_and_grad
from .optimizer import AdamWConfig, adamw_update, decay_mask


def build_ddp_train_step(cfg: ModelConfig, flags: RunFlags, oc: AdamWConfig,
                         mesh: Mesh, dp_axis: str = "data",
                         compress: bool = True) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), updated
    in place on every rank.

    ``batch`` is the global batch (the same on every rank); the rank
    computes the loss on its block of rows along ``dp_axis``, without a
    sharding context (the local step of the reference's ``shard_map``).
    The gradients are averaged over ``dp_axis`` by the int8-compressed
    all-reduce (exact ``pmean`` with ``compress=False``), the loss
    exactly."""
    loss_fn = build_loss_fn(cfg, flags)
    decay = decay_mask(cfg)
    n, i = mesh.shape[dp_axis], mesh.index((dp_axis,))

    def step(params, opt_state, batch):
        local = {k: v.narrow(0, i * (v.shape[0] // n), v.shape[0] // n)
                 for k, v in batch.items()}
        with sharding_ctx(None):
            loss, grads = value_and_grad(loss_fn, params, local)
        with sharding_ctx(mesh):
            if compress:
                grads = compressed_pmean_tree(grads, dp_axis)
            else:
                grads = tree_map(lambda g: coll.pmean(g, dp_axis), grads)
            loss = coll.pmean(loss, dp_axis)
        new_p, new_s, metrics = adamw_update(oc, params, grads, opt_state,
                                             decay)
        metrics["loss"] = loss
        return new_p, new_s, metrics

    return step
