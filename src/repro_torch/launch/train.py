"""The training entry point (PyTorch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt \\
        [--device cpu]

The reference's arguments, plus ``--device`` (the card unless it says
``cpu``). Restarts resume automatically from the newest complete
checkpoint in ``--ckpt-dir``.

``--mesh data=1,model=2`` trains the sharded step (``train.loop``) on a
mesh of ranks, one process each, on the reference's layout (the dense
weights split over ``model``, ZeRO-1's moments over ``data``), started
by torchrun::

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch engram-27b --reduced \
        --mesh data=1,model=2 --steps 3 [--device cpu]

The process group (gloo) is initialised from torchrun's environment
(``env://``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
or from ``main``'s ``init_method`` (e.g. a ``file://`` rendezvous, with
``RANK`` and ``WORLD_SIZE`` in the environment). A rank trains on card
``LOCAL_RANK`` modulo the cards present (ranks share a card when there
are fewer), or on the CPU with ``--device cpu``. Rank 0 prints and writes
``--metrics-out``.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import sys

import torch
import torch.distributed as dist

from ..configs.base import get_config
from ..data import DataConfig
from ..models.transformer import RunFlags
from ..sharding.rules import sharding_ctx
from ..train.loop import TrainConfig, train, train_with_restarts
from ..train.optimizer import AdamWConfig
from .mesh import parse_mesh


def reduced_config(arch: str):
    """The reduced (CPU-sized) config of ``arch``, e.g. ``deepseek-7b``."""
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.reduced()


def _init_ranks(device, init_method):
    """Initialise the gloo process group (``env://`` unless
    ``init_method``) and return this rank's device."""
    if init_method is None and "RANK" not in os.environ:
        raise RuntimeError(
            "--mesh trains one process per rank: start it under torchrun "
            "(python -m torch.distributed.run --nproc-per-node N -m "
            "repro_torch.launch.train ...), or pass main an init_method "
            "with RANK and WORLD_SIZE set")
    kw = {} if init_method is None else dict(
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    dist.init_process_group("gloo", init_method=init_method or "env://",
                            timeout=datetime.timedelta(seconds=600), **kw)
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device by default and "
                           "none is available; pass --device cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                       % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def main(argv=None, init_method: str | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the arch's reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, help="e.g. data=4,model=2")
    ap.add_argument("--engram", default=None,
                    choices=[None, "local", "tp", "pooled", "pooled_host"],
                    nargs="?")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the host; default the card")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    tc = TrainConfig(steps=args.steps, grad_accum=args.grad_accum,
                     log_every=args.log_every, ckpt_every=args.ckpt_every,
                     seed=args.seed)
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                    seq_len=args.seq, seed=args.seed)
    flags = RunFlags(remat=not args.no_remat, engram_strategy=args.engram)
    oc = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                     decay_steps=args.steps)
    device, mesh, lead = args.device, None, True
    if args.mesh:
        device = _init_ranks(args.device, init_method)
        lead = dist.get_rank() == 0
    try:
        if args.mesh:
            mesh = parse_mesh(args.mesh, device)
        kw = dict(flags=flags, oc=oc, device=device,
                  log=print if lead else (lambda s: None))
        with sharding_ctx(mesh):
            if args.ckpt_dir:
                res = train_with_restarts(cfg, tc, dc,
                                          ckpt_dir=args.ckpt_dir, **kw)
            else:
                res = train(cfg, tc, dc, **kw)
    finally:
        if args.mesh:
            dist.destroy_process_group()
    if not lead:
        return 0

    print(f"[train] done: {res.steps_run} steps, "
          f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}, "
          f"restarts={res.restarts}, stragglers={len(res.stragglers)}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"losses": res.losses, "restarts": res.restarts,
                       "final_step": res.final_step}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
