"""End to end: train an Engram LM on the synthetic n-gram corpus,
with checkpointing and an injected mid-run failure and automatic restart
(PyTorch port of ``examples/train_engram_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_engram_lm \\
        [--steps 200] [--inject-failure] [--ckpt-dir DIR] [--device cpu]

The dataset embeds deterministic bigram transitions (55% of tokens); the
Engram tables can memorise exactly these, the paper's motivating division
of labour (lookup vs compute). The model trains on the card unless
``--device cpu`` says otherwise.
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import EngramConfig, ModelConfig
from repro_torch.data import DataConfig
from repro_torch.train import AdamWConfig, TrainConfig, train_with_restarts


def build_cfg(args) -> ModelConfig:
    return ModelConfig(
        name="engram-lm-example", family="dense",
        n_layers=args.layers, d_model=args.d_model,
        vocab_size=args.vocab, n_heads=4, n_kv_heads=4,
        head_dim=args.d_model // 4, d_ff=args.d_model * 3,
        engram=EngramConfig(orders=(2, 3), n_heads=4, emb_dim=args.d_model,
                            table_vocab=8192,
                            layers=(1, max(2, args.layers // 2)),
                            strategy="local"),
        dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--inject-failure", action="store_true",
                    help="crash at 60%% of training and auto-restart")
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the host; default the card")
    args = ap.parse_args(argv)

    cfg = build_cfg(args)
    print(f"params: {cfg.param_count()/1e6:.1f}M "
          f"(engram tables {cfg.engram.table_params()/1e6:.1f}M)")
    if args.inject_failure:
        os.environ["REPRO_FAIL_AT_STEP"] = str(int(args.steps * 0.6))
        print(f"will inject a failure at step {int(args.steps * 0.6)}")

    tc = TrainConfig(steps=args.steps, log_every=max(args.steps // 10, 1),
                     ckpt_every=max(args.steps // 4, 1))
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=args.batch,
                    seq_len=args.seq, ngram_p=0.55)
    with tempfile.TemporaryDirectory() as tmp:
        res = train_with_restarts(
            cfg, tc, dc, ckpt_dir=args.ckpt_dir or tmp, device=args.device,
            oc=AdamWConfig(lr=2e-3, warmup_steps=max(args.steps // 20, 1),
                           decay_steps=args.steps))
    print(f"\nloss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"over {args.steps} steps, restarts={res.restarts}")
    print("engram headroom: 55% of transitions are table lookups "
          "(deterministic) — loss below ~0.45*H(zipf) means the tables "
          "are doing their job")
    return res


if __name__ == "__main__":
    main()
