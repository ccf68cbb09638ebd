"""Engram conditional memory: tables, retrieval, gated fusion (PyTorch port
of ``repro.core.engram``).

Retrieval strategies of the reference, as they run on one device:

  local         plain row gather (torch indexing, as the reference uses
                XLA's gather outside Pallas);
  local_kernel  the same gather through the engram_gather kernel (K1);
  tp / pooled   the reference's mesh strategies. Without a mesh they reduce
                to ``local`` exactly as the reference's do, and this port
                has no mesh yet;
  pooled_host   a host-offloaded table: not ported yet (ROADMAP queue 1,
                item 9).

Fusion goes through the gated_fuse kernel (K2) on the port's path.
"""
from __future__ import annotations

import torch

from ..configs.base import EngramConfig, ModelConfig
from ..kernels.engram_gather import engram_gather, engram_gather_ref
from ..kernels.gated_fuse import engram_gated_fuse
from ..models.layers import rmsnorm
from ..models.params import pd
from .hashing import engram_indices

TABLE_PAD = 4096   # the reference pads table_vocab to a multiple of this


def padded_vocab(ecfg: EngramConfig) -> int:
    return -(-ecfg.table_vocab // TABLE_PAD) * TABLE_PAD


def engram_defs(cfg: ModelConfig, dtype: str):
    """Each Engram layer owns its table set plus its fusion params."""
    e = cfg.engram
    fuse_dim = len(e.orders) * e.emb_dim
    return {"layers": [{
        "tables": pd(e.n_tables, padded_vocab(e), e.head_dim, dtype=dtype),
        "proj": pd(fuse_dim, cfg.d_model, dtype=dtype),
        "gate": pd(cfg.d_model, cfg.d_model, dtype=dtype),
        "norm": {"scale": pd(fuse_dim, init="ones")},
    } for _ in cfg.engram_layers()]}


def retrieve_local(ecfg: EngramConfig, tables, idx):
    """tables (T,V,hd); idx (B,S,T) -> (B,S,T*hd), plain per-table gather
    (K1's plain version)."""
    rows = engram_gather_ref(tables, idx)
    return rows.reshape(*rows.shape[:-2], -1)


def retrieve_local_kernel(ecfg: EngramConfig, tables, idx):
    """Local gather through the engram_gather kernel (K1)."""
    rows = engram_gather(tables, idx)
    return rows.reshape(*rows.shape[:-2], -1)


def _retrieve_host(ecfg: EngramConfig, tables, idx):
    raise NotImplementedError(
        "pooled_host retrieval (pinned host table read by K1) is ROADMAP "
        "queue 1, item 9 (multi-device retrieval)")


STRATEGIES = {
    "local": retrieve_local,
    "local_kernel": retrieve_local_kernel,
    "tp": retrieve_local,            # no mesh: the reference reduces to local
    "pooled": retrieve_local,        # no mesh: the reference reduces to local
    "pooled_host": _retrieve_host,
}


def retrieve(ecfg: EngramConfig, tables, idx, strategy: str = None):
    return STRATEGIES[strategy or ecfg.strategy](ecfg, tables, idx)


def engram_fuse(cfg: ModelConfig, fuse_params, h, rows,
                use_kernel: bool = False):
    """h (B,S,d) + retrieved rows (B,S,orders*emb) -> h'.

    ``use_kernel=True`` (the port's path) runs K2, whose whole epilogue is
    f32. The other form is the reference model's: it casts the sigmoid gate
    to ``h.dtype`` before the multiply, so in bf16 the two round
    differently (at f32 they differ only in summation order)."""
    rows = rmsnorm(fuse_params["norm"], rows, cfg.norm_eps)
    if use_kernel:
        return engram_gated_fuse(h, rows, fuse_params["gate"],
                                 fuse_params["proj"])
    update = rows @ fuse_params["proj"]
    gate = torch.sigmoid((h @ fuse_params["gate"]).float())
    return h + gate.to(h.dtype) * update


def engram_lookup(cfg: ModelConfig, eng_params, tokens, layer_slot: int = 0,
                  strategy=None):
    """tokens (B,S) -> rows (B,S,orders*emb). Retrieval only, no fusion."""
    e = cfg.engram
    idx = engram_indices(e, tokens)
    return retrieve(e, eng_params["layers"][layer_slot]["tables"], idx,
                    strategy)
