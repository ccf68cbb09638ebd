"""The reference's ``shard_map`` collectives on ``torch.distributed``, over
the process groups of the current mesh (``rules.current_ctx().mesh``).

Each takes mesh axes as the reference names them (one axis or a tuple in
layout order, flattened row-major) and runs on the tensor's own device:
gloo on CPU tensors (the CPU tests), whatever backend the mesh's groups
have on CUDA tensors. Nothing here stages a tensor to the host.

A call on a floating tensor under autograd (grad enabled, the input
requiring grad) is a ``torch.autograd.Function`` whose backward is the
collective's transpose over the ranks, each rank's cotangent read as its
share of the sum (so ``psum``'s transpose is ``psum``, as in a
``shard_map`` under ``jax.grad``). Integer tensors and calls without
grad run the collective alone, ``psum`` in place.

  all_to_all   ``jax.lax.all_to_all(x, axes, 0, 0, tiled=False)``
               (``dist.all_to_all_single``); backward: ``all_to_all``
  psum         ``jax.lax.psum`` (``dist.all_reduce``, in place without
               grad; into a copy under autograd); backward: ``psum``
  pmean        ``jax.lax.pmean``: ``psum`` / n
  pmax         ``jax.lax.pmax`` (``dist.all_reduce`` with MAX), without
               a gradient
  psum_scatter ``jax.lax.psum_scatter(x, axes, scatter_dimension=dim,
               tiled=True)`` (``dist.reduce_scatter_single``, named
               ``reduce_scatter_tensor`` before torch 2.13); backward:
               the all-gather of the blocks along ``dim``
  all_gather   ``jax.lax.all_gather(x, axes)``: every rank's ``x``
               stacked on a new leading axis, in rank order
               (``dist.all_gather_single``, named
               ``all_gather_into_tensor`` before torch 2.13); backward:
               ``psum_scatter`` along the new axis
  gather_dim   the blocks of ``dim`` from every rank of ``axes``, in rank
               order: what GSPMD does where a ``shard_map``'s sharded
               output meets an op that needs it whole. Built on
               ``all_reduce`` of the block placed in zeros (exact: each
               element has one nonzero term); backward: ``psum`` of the
               cotangent, narrowed to the rank's block
  gather_block the whole tensor from every rank's block of it
               (``gather_dim`` along each split dim)
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


def _tracked(x: torch.Tensor) -> bool:
    """Whether autograd records a call on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad and \
        x.is_floating_point()


def axis_index(axes) -> int:
    """This rank's row-major linear index over ``axes``."""
    return _mesh().index(axes)


# ----------------------------------------------------- the collectives alone

def _all_to_all(x, g):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=g)
    return out


def _psum_(x, g):
    dist.all_reduce(x, group=g)
    return x


def _pmax_(x, g):
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


def _psum_scatter(x, g, dim):
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // g.size(),) + tuple(xt.shape[1:]))
    _reduce_scatter(out, xt, group=g)
    return out.movedim(0, dim)


def _gather_along(x, g, dim):
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((g.size() * xt.shape[0],) + tuple(xt.shape[1:]))
    _all_gather(out, xt, group=g)
    return out.movedim(0, dim)


def _gather_dim(x, g, index, dim):
    shape = list(x.shape)
    shape[dim] *= g.size()
    out = x.new_zeros(shape)
    out.narrow(dim, index * x.shape[dim], x.shape[dim]).copy_(x)
    return _psum_(out, g)


# ------------------------------------------------ under autograd: transposes

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _all_to_all(x, g)

    @staticmethod
    def backward(ctx, gy):
        return _all_to_all(gy, ctx.g), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _psum_(x.clone(memory_format=torch.contiguous_format), g)

    @staticmethod
    def backward(ctx, gy):
        return _psum_(gy.clone(memory_format=torch.contiguous_format),
                      ctx.g), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _psum_scatter(x, g, dim)

    @staticmethod
    def backward(ctx, gy):
        return _gather_along(gy, ctx.g, ctx.dim), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _gather_along(x[None], g, 0)

    @staticmethod
    def backward(ctx, gy):
        return _psum_scatter(gy, ctx.g, 0)[0], None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, index, dim):
        ctx.g, ctx.index, ctx.dim, ctx.n = g, index, dim, x.shape[dim]
        return _gather_dim(x, g, index, dim)

    @staticmethod
    def backward(ctx, gy):
        whole = _psum_(gy.clone(memory_format=torch.contiguous_format),
                       ctx.g)
        return whole.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, \
            None


# ------------------------------------------------------------------ the API

def all_to_all(x: torch.Tensor, axes) -> torch.Tensor:
    """x (N, ...) with N the ranks over ``axes``: block i goes to rank i;
    returns (N, ...) whose block i came from rank i."""
    g = _mesh().group(axes)
    return _AllToAll.apply(x, g) if _tracked(x) else _all_to_all(x, g)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum over the ranks of ``axes``: written into ``x`` without
    grad, a new tensor under autograd."""
    g = _mesh().group(axes)
    return _Psum.apply(x, g) if _tracked(x) else _psum_(x, g)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    """The elementwise max over the ranks of ``axes``, written into ``x``
    (``jax.lax.pmax``); no gradient flows through it."""
    if _tracked(x):
        raise ValueError("pmax has no gradient: pass a detached tensor")
    return _pmax_(x, _mesh().group(axes))


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    n = _mesh().group(axes).size()
    return psum(x, axes) / n


def psum_scatter(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The sum over the ranks of ``axes``, of which this rank keeps block
    ``index`` of ``dim`` (rank i the i-th of N equal blocks)."""
    g = _mesh().group(axes)
    return _PsumScatter.apply(x, g, dim) if _tracked(x) else \
        _psum_scatter(x, g, dim)


def all_gather(x: torch.Tensor, axes) -> torch.Tensor:
    """(N, *x.shape): rank i's ``x`` at index i, N the ranks of ``axes``."""
    g = _mesh().group(axes)
    return _AllGather.apply(x, g) if _tracked(x) else \
        _gather_along(x[None], g, 0)


def gather_dim(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """Every rank's block of ``dim`` over ``axes``, concatenated in rank
    order."""
    mesh = _mesh()
    g, index = mesh.group(axes), mesh.index(axes)
    return _GatherDim.apply(x, g, index, dim) if _tracked(x) else \
        _gather_dim(x, g, index, dim)


def gather_block(x: torch.Tensor, shape, logical_axes) -> torch.Tensor:
    """The whole tensor of ``shape`` from this rank's block ``x`` of it
    under ``logical_axes`` (``ShardCtx.block``'s inverse, a ``Fused``
    leaf's parts put back in order), gathered over each split dim's axes;
    a whole ``x`` comes back as it is."""
    ctx = current_ctx()
    for dim, entry in enumerate(ctx.spec_for(tuple(shape),
                                             tuple(logical_axes))):
        if entry is not None and x.shape[dim] != shape[dim]:
            axes = (entry,) if isinstance(entry, str) else entry
            x = gather_dim(x, axes, dim)
            if dim == getattr(logical_axes, "dim", -1):
                # (rank, part, block) -> (part, rank, block)
                x = x.unflatten(dim, (ctx.axis_prod(axes),
                                      logical_axes.parts, -1)) \
                    .transpose(dim, dim + 1).flatten(dim, dim + 2)
    return x
