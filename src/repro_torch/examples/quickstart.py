"""Quickstart: Engram conditional memory + CXL-pool feasibility (PyTorch
port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a small Engram-augmented LM and shows the three pieces of the
paper: (1) hash-only retrieval indices (prefetchable), (2) pooled lookup
and gated fusion in a forward pass and its loss, (3) the §3.2 feasibility
check for DRAM/CXL/RDMA. The model runs on the card unless ``--device
cpu`` says otherwise.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import deepseek_7b
from repro_torch.configs.base import ENGRAM_27B, EngramConfig
from repro_torch.core.engram import engram_lookup
from repro_torch.core.hashing import engram_indices
from repro_torch.data import DataConfig, TokenPipeline, shard_batch
from repro_torch.device import resolve_device
from repro_torch.models.model import build_loss_fn, init_params
from repro_torch.models.transformer import RunFlags
from repro_torch.pool import check_all_tiers, latency_sweep, paper_case_study


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host; default the card")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = deepseek_7b.reduced()
    e = cfg.engram
    print(f"model: {cfg.name}  layers={cfg.n_layers} d_model={cfg.d_model}")
    print(f"engram: orders={e.orders} heads={e.n_heads} "
          f"tables={e.n_tables} x {e.table_vocab} rows, "
          f"{e.bytes_per_token_layer} B/token/layer at layers "
          f"{cfg.engram_layers()}")

    # 1. indices depend only on token IDs -> prefetchable at step start
    toks = torch.tensor([[11, 22, 33, 44, 55]], dtype=torch.int32,
                        device=dev)
    idx = engram_indices(e, toks)
    print(f"\n[1] engram indices (B,S,T) = {tuple(idx.shape)}; "
          f"first token -> rows {idx[0, 0][:4].tolist()}...")

    # 2. retrieval + the loss of a forward through the gated fusion
    params = init_params(cfg, 0, dev)
    rows = engram_lookup(cfg, params["engram"], toks)
    print(f"[2] retrieved rows {tuple(rows.shape)} "
          f"({rows.dtype}, {rows.numel() * rows.element_size()} B)")
    dc = DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=32)
    batch = shard_batch(TokenPipeline(dc).batch_at(0), device=dev)
    loss = build_loss_fn(cfg, RunFlags())(params, batch)
    print(f"    one forward+loss through 2 Engram layers: "
          f"loss={float(loss):.3f}")

    # 3. the paper's feasibility model (Table 1 case study)
    print("\n[3] §3.2 feasibility @ Qwen3-32B-like point "
          "(70k tok/s, 3.6 ms step, 64 layers):")
    for tier, f in check_all_tiers(EngramConfig(**ENGRAM_27B),
                                   paper_case_study()).items():
        print(f"    {tier:5s} window={f.prefetch_window_s*1e6:6.1f}us "
              f"latency={f.retrieval_latency_s*1e6:8.1f}us  "
              f"{'OK — retrieval hides' if f.ok else 'STALLS'}")

    print("\n[4] Fig 3-style latency sweep (Engram-27B, us):")
    sweep = latency_sweep(EngramConfig(**ENGRAM_27B),
                          batch_sizes=(1, 64, 256, 1024))
    print("    batch " + "".join(f"{t:>10s}" for t in sweep))
    for i, b in enumerate((1, 64, 256, 1024)):
        print(f"    {b:5d} " + "".join(f"{sweep[t][i][1]:10.1f}"
                                       for t in sweep))
    return float(loss), np.asarray(idx.cpu())


if __name__ == "__main__":
    main()
