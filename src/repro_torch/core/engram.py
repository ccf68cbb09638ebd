"""Engram conditional memory: tables, retrieval, gated fusion (PyTorch port
of ``repro.core.engram``).

Retrieval strategies of the reference, as they run on one device:

  local         plain row gather (``_take_rows``: one torch indexing op over
                the flattened table, as the reference gathers with XLA
                outside Pallas);
  local_kernel  the same gather through the engram_gather kernel (K1);
  tp / pooled   the reference's mesh strategies. Without a mesh they reduce
                to ``local`` exactly as the reference's do, and this port
                has no mesh yet;
  pooled_host   the tables live in pinned, device-mapped host memory (the
                paper's CXL pool as the card sees it: memory beside the
                host, read over the host link). K1 reads each row in place
                from the card into device memory (``retrieve_host``, the
                paper's Listing 2); the weights and KV stay on the card.
                ``models.params`` places the tables there
                (``table_memory="pinned_host"``, ``tables_to_host``). On
                the CPU the tables are plain CPU tensors and the gather is
                K1's plain version.

``StrategySpec.store`` resolves each strategy to the store modelling what
its placement costs (``pool.store.STRATEGY_TIERS``). Fusion goes through
the gated_fuse kernel (K2) on the port's path.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import EngramConfig, ModelConfig
from ..kernels.engram_gather import engram_gather
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


def _take_rows(tables, idx):
    """tables (T,V,hd); idx (...,T) -> (...,T,hd): the reference's
    per-table ``jnp.take`` as one gather over the flattened (T*V, hd)
    table (row ``idx[..., t] + t*V``), not T gathers and a stack."""
    T, V, hd = tables.shape
    gid = idx.to(torch.int64) + torch.arange(
        T, device=idx.device, dtype=torch.int64) * V
    flat = tables.reshape(T * V, hd)
    return flat.index_select(0, gid.reshape(-1)).view(*idx.shape, hd)


def retrieve_local(ecfg: EngramConfig, tables, idx):
    """tables (T,V,hd); idx (B,S,T) -> (B,S,T*hd), plain row gather."""
    rows = _take_rows(tables, idx)
    return rows.reshape(*rows.shape[:-2], -1)


def retrieve_local_kernel(ecfg: EngramConfig, tables, idx):
    """Local gather through the engram_gather kernel (K1)."""
    rows = engram_gather(tables, idx)
    return rows.reshape(*rows.shape[:-2], -1)


def retrieve_host(ecfg: EngramConfig, tables, idx):
    """tables (T,V,hd) in host memory; idx (B,S,T) -> (B,S,T*hd) on idx's
    device. On the card K1 reads the rows in place from the pinned, mapped
    host tables (``engram_gather`` on a mapped CPU tensor); the reference
    instead gathers on the host under ``compute_on("device_host")`` and the
    rows then move to the device. Both give the same rows. ``idx`` on the
    CPU takes K1's plain version. Tables on the card raise: this strategy
    is a placement, and tables in HBM are ``local``'s."""
    if tables.device.type != "cpu":
        raise ValueError(f"pooled_host retrieval reads tables in host "
                         f"memory; these live on {tables.device}")
    rows = engram_gather(tables, idx)
    return rows.reshape(*rows.shape[:-2], -1)


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """A retrieval strategy: where the rows live and how they are read.
    What that placement costs (tier latency, hot-row cache, prefetch
    windows) is the store's concern: ``spec.store(ecfg)`` resolves the
    matching ``EngramStore`` through ``pool.store.STRATEGY_TIERS``."""
    name: str
    fn: object                        # (ecfg, tables, idx) -> rows

    def store(self, ecfg: EngramConfig):
        from ..pool.store import store_for_strategy
        return store_for_strategy(ecfg, self.name)


STRATEGIES = {
    s.name: s for s in (
        StrategySpec("local", retrieve_local),
        StrategySpec("local_kernel", retrieve_local_kernel),
        StrategySpec("tp", retrieve_local),   # no mesh: reduces to local
        StrategySpec("pooled", retrieve_local),
        StrategySpec("pooled_host", retrieve_host),
    )
}


def retrieve(ecfg: EngramConfig, tables, idx, strategy: str = None):
    return STRATEGIES[strategy or ecfg.strategy].fn(ecfg, tables, idx)


def strategy_store(ecfg: EngramConfig, strategy: str = None):
    """The EngramStore modelling the cost of ``strategy``'s placement."""
    return STRATEGIES[strategy or ecfg.strategy].store(ecfg)


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
