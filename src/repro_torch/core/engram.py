"""Engram conditional memory: tables, retrieval, gated fusion (PyTorch port
of ``repro.core.engram``).

Retrieval strategies (the paper's storage tiers, mapped to a mesh of
ranks, one process per rank on ``torch.distributed``):

  local         plain row gather (``_take_rows``: one torch indexing op over
                the flattened table, as the reference gathers with XLA
                outside Pallas);
  local_kernel  the same gather through the engram_gather kernel (K1);
  tp            table row-sharded over the model axis: masked local gather
                + reduce-scatter over the model axis. The rank's rows come
                back as its block of the fused-embedding dim;
  pooled        the CXL-pool analogue: table row-sharded over EVERY mesh
                axis; each rank dedups its requests, routes them to the
                owner ranks through a fixed-capacity all_to_all over the
                flattened mesh, the owners read their rows (K1: the pool
                read), and a reverse all_to_all returns them;
  pooled_host   the tables live in pinned, device-mapped host memory (the
                paper's CXL pool as the card sees it: memory beside the
                host, read over the host link). K1 reads each row in place
                from the card into device memory (``retrieve_host``, the
                paper's Listing 2); the weights and KV stay on the card.
                ``models.params`` places the tables there
                (``table_memory="pinned_host"``, ``tables_to_host``). On
                the CPU the tables are plain CPU tensors and the gather is
                K1's plain version.

``tp`` and ``pooled`` read the current sharding context
(``sharding.rules.sharding_ctx``). Without one, or where the reference
falls back (no pool axis, one rank, a vocabulary the ranks do not divide),
they run ``local`` as the reference's do. Under a mesh each takes the
rank's share of the batch (the reference's batch spec) and either the
whole tables or the rank's block of their rows.

``StrategySpec.store`` resolves each strategy to the store modelling what
its placement costs (``pool.store.STRATEGY_TIERS``). Fusion goes through
the gated_fuse kernel (K2) on the port's path.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import trace
from ..configs.base import EngramConfig, ModelConfig
from ..kernels.engram_gather import engram_gather, gather_rows
from ..kernels.gated_fuse import engram_gated_fuse
from ..models.layers import rmsnorm, value_counts
from ..models.params import pd
from ..sharding import collectives as coll
from ..sharding.rules import current_ctx, rank_block
from .hashing import engram_indices

TABLE_PAD = 4096   # the reference pads table_vocab to a multiple of this


def padded_vocab(ecfg: EngramConfig) -> int:
    return -(-ecfg.table_vocab // TABLE_PAD) * TABLE_PAD


def engram_defs(cfg: ModelConfig, dtype: str):
    """Each Engram layer owns its table set plus its fusion params."""
    e = cfg.engram
    fuse_dim = len(e.orders) * e.emb_dim
    return {"layers": [{
        "tables": pd(e.n_tables, padded_vocab(e), e.head_dim,
                     axes=(None, "eng_vocab", None), dtype=dtype),
        "proj": pd(fuse_dim, cfg.d_model, axes=("eng_emb", None),
                   dtype=dtype),
        "gate": pd(cfg.d_model, cfg.d_model, axes=(None, None), dtype=dtype),
        "norm": {"scale": pd(fuse_dim, init="ones")},
    } for _ in cfg.engram_layers()]}


def _flat_rows(tables):
    """tables (T, V, hd) with unit stride along hd -> (rows, per_table): a
    (R, hd) view whose row ``t * per_table + v`` is ``tables[t, v]``, over
    the tables' own storage. A contiguous table set gives (T*V, hd); a
    rank's block of a whole table set (rows narrowed) keeps the whole set's
    table stride, and the view spans from the block's first row to its
    last, reading none of the rows between the tables' blocks."""
    T, V, hd = tables.shape
    s_t, s_v, s_h = tables.stride()
    if s_h != 1 or s_v < hd or s_t % s_v:
        raise ValueError(f"tables of strides {tables.stride()}: rows of "
                         f"{hd} with unit stride, tables a whole number of "
                         "rows apart")
    per_table = s_t // s_v
    return tables.as_strided(((T - 1) * per_table + V, hd), (s_v, 1),
                             tables.storage_offset()), per_table


def _take_rows(tables, idx):
    """tables (T,V,hd); idx (...,T) -> (...,T,hd): the reference's
    per-table ``jnp.take`` as one gather over the flattened table (row
    ``idx[..., t] + t*V``, ``_flat_rows``), not T gathers and a stack."""
    T, V, hd = tables.shape
    flat, per_table = _flat_rows(tables)
    gid = idx.to(torch.int64) + torch.arange(
        T, device=idx.device, dtype=torch.int64) * per_table
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


def retrieve_tp(ecfg: EngramConfig, tables, idx):
    """Tables row-sharded over the model axis: masked local gather, then a
    reduce-scatter over the model axis along the fused-embedding dim. Each
    rank gets (B_loc, S, T*hd / n_model): its block of the fused dim (the
    reference's out_spec), exactly what a TP projection consumes."""
    ctx = current_ctx()
    axes = tuple(a for a in ("model",) if ctx and a in ctx.mesh.axis_names)
    if ctx is None or not axes:
        return retrieve_local(ecfg, tables, idx)
    n = ctx.mesh.shape[axes[0]]
    v_pad = padded_vocab(ecfg)
    if v_pad % n != 0:
        return retrieve_local(ecfg, tables, idx)
    v_loc = v_pad // n
    tab = rank_block(tables, 1, v_pad, axes, ctx)
    rel = idx - coll.axis_index(axes) * v_loc
    okm = (rel >= 0) & (rel < v_loc)
    rows = _take_rows(tab, rel.clamp(0, v_loc - 1))
    rows = rows * okm[..., None].to(rows.dtype)
    rows = rows.reshape(*idx.shape[:2], -1)
    return coll.psum_scatter(rows, axes, dim=2)


def retrieve_pooled(ecfg: EngramConfig, tables, idx, *, slack: float = 2.0,
                    use_kernel: bool = True):
    """CXL-pool analogue: fixed-capacity request/reply all_to_all over every
    mesh axis (the table row-sharded over all of them).

    The rank owns rows [o*v_loc, (o+1)*v_loc) of every table, o its
    row-major index over the pool axes; ``idx`` (B_loc, S, T) is its share
    of the requests. Each unique (table, row) is requested once (a hot
    n-gram costs one fetch), each owner takes at most
    ``ceil(R / N * slack)`` of a rank's R requests (later ones are dropped:
    their rows come back as zeros, as in the reference), the owner reads
    the rows through K1 (``gather_rows``: the pool read; with
    ``use_kernel=False`` by plain indexing, as the reference reads them,
    which autograd differentiates: training's route), and the rows fan
    out to every duplicate. Returns (B_loc, S, T*hd)."""
    ctx = current_ctx()
    if ctx is None:
        return retrieve_local(ecfg, tables, idx)
    pool_axes = tuple(a for a in ctx.rules.get("eng_vocab", ())
                      if a in ctx.mesh.axis_names)
    if not pool_axes:
        return retrieve_local(ecfg, tables, idx)
    N = ctx.axis_prod(pool_axes)
    v_pad = padded_vocab(ecfg)
    if N == 1 or v_pad % N != 0:
        return retrieve_local(ecfg, tables, idx)
    v_loc = v_pad // N
    T, hd = ecfg.n_tables, ecfg.head_dim
    flat, per_table = _flat_rows(rank_block(tables, 1, v_pad, pool_axes, ctx))
    B, S = idx.shape[:2]
    dev = idx.device
    ar = lambda n: torch.arange(n, device=dev)             # noqa: E731
    flat_i = idx.reshape(-1).to(torch.int64)
    R = flat_i.numel()
    flat_tid = ar(T).repeat(B * S)

    # dedup: each unique (table, row) is fetched once per rank. Every sort
    # is stable, as jnp.argsort is.
    sk, korder = torch.sort(flat_tid * v_pad + flat_i, stable=True)
    is_first = torch.ones(R, dtype=torch.bool, device=dev)
    is_first[1:] = sk[1:] != sk[:-1]
    gid_sorted = torch.cumsum(is_first, 0) - 1               # group per pos
    cpos = torch.sort(torch.where(is_first, ar(R), R)).values
    u_valid = cpos < R                   # cpos[g]: sorted pos of group g
    u_key = sk[cpos.clamp(max=R - 1)]
    u_row, u_tid = u_key % v_pad, u_key // v_pad

    dest = torch.where(u_valid, u_row // v_loc, N)           # N = drop
    s_dst, order = torch.sort(dest, stable=True)
    s_row, s_tid = u_row[order], u_tid[order]
    cap = int(math.ceil(R / N * slack))
    # jnp.bincount(length=N) drops the values >= N (dest N: dropped)
    counts = value_counts(dest, N + 1)[:N]
    starts = torch.cumsum(counts, 0) - counts
    pos = ar(R) - starts[s_dst.clamp(max=N - 1)]
    ok = (pos < cap) & (s_dst < N)
    pos_c = torch.where(ok, pos, cap)
    dst_c = s_dst.clamp(max=N - 1)
    # slot cap is the spill slot: every dropped or invalid request lands
    # there, the only place two writes meet, and it is sliced away
    send_req = torch.full((N, cap + 1), -1, dtype=torch.int32, device=dev)
    send_tid = torch.zeros((N, cap + 1), dtype=torch.int32, device=dev)
    send_rid = torch.full((N, cap + 1), R, dtype=torch.int64, device=dev)
    send_req[dst_c, pos_c] = (s_row % v_loc).to(torch.int32)
    send_tid[dst_c, pos_c] = s_tid.to(torch.int32)
    send_rid[dst_c, pos_c] = order
    # request -> owner
    recv_req = coll.all_to_all(send_req[:, :cap], pool_axes)
    recv_tid = coll.all_to_all(send_tid[:, :cap], pool_axes)
    # owner-side gather: the pool read, through K1 or plain indexing
    safe = recv_req.clamp(0, v_loc - 1).to(torch.int64)
    gid = (recv_tid.to(torch.int64) * per_table + safe).reshape(-1)
    rows = gather_rows(flat, gid) if use_kernel else flat[gid]  # (N*cap, hd)
    rows = rows * (recv_req.reshape(-1) >= 0)[:, None].to(rows.dtype)
    # reply -> requester: each row lands in its unique group's slot, then
    # fans out to every duplicate
    back = coll.all_to_all(rows.view(N, cap, hd), pool_axes)
    rid = send_rid[:, :cap].reshape(N * cap)
    rows_u = rows.new_zeros((R + 1, hd)).index_add_(
        0, torch.where(rid < R, rid, R), back.reshape(N * cap, hd))
    out = rows.new_zeros((R, hd)).index_copy_(0, korder, rows_u[gid_sorted])
    return out.view(B, S, T * hd)


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
        StrategySpec("tp", retrieve_tp),
        StrategySpec("pooled", retrieve_pooled),
        StrategySpec("pooled_host", retrieve_host),
    )
}


def retrieve(ecfg: EngramConfig, tables, idx, strategy: str = None,
             use_kernel: bool = True):
    """Rows by ``strategy`` (default the config's); ``use_kernel=False``
    makes ``pooled``'s owners read without K1 (training)."""
    name = strategy or ecfg.strategy
    with trace.span("engram.retrieve", rows=idx.numel()):
        if name == "pooled":
            return retrieve_pooled(ecfg, tables, idx, use_kernel=use_kernel)
        return STRATEGIES[name].fn(ecfg, tables, idx)


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
    with trace.span("engram.fuse", T=h.numel() // h.shape[-1]):
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
