"""The reference's ``shard_map`` collectives on ``torch.distributed``, over
the process groups of the current mesh (``rules.current_ctx().mesh``).

Each takes mesh axes as the reference names them (one axis or a tuple in
layout order, flattened row-major) and runs on the tensor's own device:
gloo on CPU tensors (the CPU tests), whatever backend the mesh's groups
have on CUDA tensors. Nothing here stages a tensor to the host.

  all_to_all   ``jax.lax.all_to_all(x, axes, 0, 0, tiled=False)``
               (``dist.all_to_all_single``)
  psum         ``jax.lax.psum`` (``dist.all_reduce``, in place)
  pmean        ``jax.lax.pmean``
  psum_scatter ``jax.lax.psum_scatter(x, axes, scatter_dimension=dim,
               tiled=True)`` (``dist.reduce_scatter_single``, named
               ``reduce_scatter_tensor`` before torch 2.13)
  all_gather   ``jax.lax.all_gather(x, axes)``: every rank's ``x``
               stacked on a new leading axis, in rank order
               (``dist.all_gather_single``, named
               ``all_gather_into_tensor`` before torch 2.13)
  gather_dim   the blocks of ``dim`` from every rank of ``axes``, in rank
               order: what GSPMD does where a ``shard_map``'s sharded
               output meets an op that needs it whole. Built on
               ``all_reduce`` of the block placed in zeros (exact: each
               element has one nonzero term).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .rules import current_ctx

# torch 2.13 renamed reduce_scatter_tensor and all_gather_into_tensor (and
# deprecates the old names)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _mesh():
    ctx = current_ctx()
    if ctx is None:
        raise ValueError("a collective needs a sharding context")
    return ctx.mesh


def axis_index(axes) -> int:
    """This rank's row-major linear index over ``axes``."""
    return _mesh().index(axes)


def all_to_all(x: torch.Tensor, axes) -> torch.Tensor:
    """x (N, ...) with N the ranks over ``axes``: block i goes to rank i;
    returns (N, ...) whose block i came from rank i."""
    mesh = _mesh()
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axes))
    return out


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum over the ranks of ``axes``, written into ``x``."""
    dist.all_reduce(x, group=_mesh().group(axes))
    return x


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    mesh = _mesh()
    n = mesh.group(axes).size()
    return psum(x, axes) / n


def psum_scatter(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``axes``, of which this rank keeps block
    ``index`` of ``dim`` (rank i the i-th of N equal blocks)."""
    mesh = _mesh()
    g = mesh.group(axes)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // g.size(),) + tuple(xt.shape[1:]))
    _reduce_scatter(out, xt, group=g)
    return out.movedim(0, dim)


def all_gather(x: torch.Tensor, axes) -> torch.Tensor:
    """(N, *x.shape): rank i's ``x`` at index i, N the ranks of ``axes``."""
    g = _mesh().group(axes)
    out = x.new_empty(g.size() * x.numel())
    _all_gather(out, x.contiguous().view(-1), group=g)
    return out.view((g.size(),) + tuple(x.shape))


def gather_dim(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """Every rank's block of ``dim`` over ``axes``, concatenated in rank
    order."""
    mesh = _mesh()
    n = mesh.group(axes).size()
    shape = list(x.shape)
    shape[dim] *= n
    out = x.new_zeros(shape)
    out.narrow(dim, mesh.index(axes) * x.shape[dim], x.shape[dim]).copy_(x)
    return psum(out, axes)
