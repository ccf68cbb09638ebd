"""The training entry point (PyTorch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
        --reduced --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt \\
        [--device cpu]

The reference's arguments, plus ``--device`` (the card unless it says
``cpu``). Restarts resume automatically from the newest complete
checkpoint in ``--ckpt-dir``. ``--mesh`` names the reference's sharded
train step, which is not ported (ROADMAP item 10b): it raises rather than
training on one device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys

from ..configs.base import get_config
from ..data import DataConfig
from ..models.transformer import RunFlags
from ..train.loop import TrainConfig, train, train_with_restarts
from ..train.optimizer import AdamWConfig


def reduced_config(arch: str):
    """The reduced (CPU-sized) config of ``arch``, e.g. ``deepseek-7b``."""
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.reduced()


def main(argv=None) -> int:
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
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: the sharded train step is not ported "
            "(ROADMAP item 10b, training under the mesh)")

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    tc = TrainConfig(steps=args.steps, grad_accum=args.grad_accum,
                     log_every=args.log_every, ckpt_every=args.ckpt_every,
                     seed=args.seed)
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                    seq_len=args.seq, seed=args.seed)
    flags = RunFlags(remat=not args.no_remat, engram_strategy=args.engram)
    oc = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                     decay_steps=args.steps)
    kw = dict(flags=flags, oc=oc, device=args.device)
    if args.ckpt_dir:
        res = train_with_restarts(cfg, tc, dc, ckpt_dir=args.ckpt_dir, **kw)
    else:
        res = train(cfg, tc, dc, **kw)

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
