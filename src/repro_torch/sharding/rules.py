"""Logical-axis sharding rules with divisibility-aware fallback (PyTorch
port of ``repro.sharding.rules``).

Model code tags tensors with *logical* axes ("batch", "heads", "ffn",
"eng_vocab", ...). A ``ShardCtx`` resolves them onto mesh axes. Axes that
don't exist in the mesh or don't divide the dimension are dropped
(replicated), exactly as the reference drops them.

The reference runs on one controller: a ``NamedSharding`` places each
array's blocks on the devices and a ``shard_map`` body sees one device's
block. The port runs one process per rank (``torch.distributed``), and a
rank holds only its own blocks: ``local_params`` is the counterpart of
``device_put`` with the reference's ``params_shardings``, and the
functions that enter a ``shard_map`` in the reference run its body on
the rank's blocks with the collectives of ``sharding.collectives``.

``Mesh`` describes the mesh: its axis names and sizes and, when ranks
exist, this rank's coordinate on each axis and the axes' process groups
(``launch.mesh.make_mesh`` builds one over ``torch.distributed``). A
``Mesh`` without ranks still resolves specs (``ShardCtx.spec_for``).

The reference places every parameter with ``params_shardings``: its
``NamedSharding`` splits each leaf along the mesh axes its logical axes
resolve to, and GSPMD partitions the dense layers around those blocks
(tensor parallelism over ``model``). The port holds the same blocks
(``local_params``; ``models.model.mesh_logical_axes``) and runs the
dense layers on them with explicit collectives: a column-parallel
product reads the whole activation and writes the rank's block of the
output features, a row-parallel one reads the rank's block of the input
features and sums the partial products over the axis (``psum``).
``ShardCtx.dim_block`` says which block of a dim a rank holds.

A fused leaf (``Fused``: Mamba's ``in_proj`` [x | z], mLSTM's ``up``,
sLSTM's ``ff_up``, two equal parts along the split dim) is split part
by part: the rank holds its block of each part, side by side, so its
block has the reference's shape and bytes and the rank computes on its
own features (the reference's contiguous block would give the first
ranks only x).

The reference's ``shard`` and its ``compat_*`` shims have no counterpart.
``shard`` is a sharding constraint for XLA's GSPMD partitioner, which has
no equivalent in eager PyTorch: the port's functions take their blocks
and say where the collectives go. The shims cover JAX version skew.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import torch

# Default logical -> mesh axis mapping (the reference's). Tuples shard over
# multiple axes.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch":     ("pod", "data"),
    "seq":       (),                 # sequence usually unsharded
    "kv_seq":    (),                 # decode KV-sequence sharding override
    "vocab":     ("model",),
    "embed":     (),
    "heads":     ("model",),
    "kv_heads":  ("model",),
    "ffn":       ("model",),
    "experts":   ("model",),
    "eng_vocab": ("pod", "data", "model"),   # the pooled table: everything
    "eng_emb":   ("model",),                 # fused-embedding dim (tp)
    "layers":    (),
    "lora":      (),
    "conv":      (),
    "state":     (),
    "opt":       ("data",),          # ZeRO-1 optimizer-state extra axis
}


class Fused(tuple):
    """The logical axes of a leaf that fuses ``parts`` equal groups of
    features along dim ``dim`` (its split dim): a tuple of axis names
    that also carries ``parts`` and ``dim``. A rank's block of such a
    leaf is its block of each part, concatenated in part order
    (``ShardCtx.block``); ``sharding.collectives.gather_block`` puts the
    parts back in order."""

    def __new__(cls, axes, parts: int, dim: int):
        self = super().__new__(cls, axes)
        self.parts, self.dim = parts, dim
        return self

    def __reduce__(self):
        return (Fused, (tuple(self), self.parts, self.dim))


@dataclasses.dataclass
class Mesh:
    """A mesh: ``axis_names`` in layout order and ``shape`` (name -> size),
    as a ``jax.sharding.Mesh`` gives them. Ranks are laid out row-major
    over the axes. With ranks, ``coords`` is this rank's coordinate on each
    axis and ``groups`` maps a tuple of axes (in layout order) to the
    process group of the ranks that share this rank's coordinates on every
    other axis, its group ranks in row-major order over those axes."""
    axis_names: tuple[str, ...]
    shape: dict[str, int]
    coords: Optional[dict[str, int]] = None
    groups: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, shape: tuple[int, ...], axes: tuple[str, ...], **kw) -> "Mesh":
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} for axes {axes}")
        return cls(tuple(axes), dict(zip(axes, shape)), **kw)

    def ordered(self, axes) -> tuple[str, ...]:
        """``axes`` as a tuple, checked to be mesh axes in layout order (the
        order the reference's rules name them in, and the order a group's
        ranks follow)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [self.axis_names.index(a) for a in axes]
        if pos != sorted(set(pos)):
            raise ValueError(f"axes {axes} are not mesh axes {self.axis_names}"
                             " in layout order")
        return axes

    def index(self, axes) -> int:
        """This rank's row-major linear index over ``axes`` (the reference's
        ``_linear_index``; ``jax.lax.axis_index`` of a single axis)."""
        if self.coords is None:
            raise ValueError("a mesh without ranks has no axis index")
        acc = 0
        for a in self.ordered(axes):
            acc = acc * self.shape[a] + self.coords[a]
        return acc

    def group(self, axes):
        """The process group over ``axes`` (see the class docstring)."""
        axes = self.ordered(axes)
        if axes not in self.groups:
            raise ValueError(f"mesh has no process group over {axes}")
        return self.groups[axes]


@dataclasses.dataclass
class ShardCtx:
    mesh: Mesh
    rules: dict[str, tuple[str, ...]]

    def resolve(self, logical: Optional[str]) -> tuple[str, ...]:
        if logical is None:
            return ()
        axes = self.rules.get(logical, ())
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in axes if a in self.mesh.axis_names)

    def axis_prod(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def spec_for(self, shape: tuple[int, ...],
                 logical_axes: tuple[Optional[str], ...]) -> tuple:
        """The reference's PartitionSpec as a tuple: one entry per leading
        dim, a mesh axis, a tuple of them, or None; trailing Nones dropped.
        Divisibility fallback: drop the innermost axis until the dim
        divides."""
        entries, used = [], set()
        for dim, name in zip(shape, logical_axes):
            axes = tuple(a for a in self.resolve(name) if a not in used)
            while axes and dim % self.axis_prod(axes) != 0:
                axes = axes[:-1]          # drop innermost axis, retry
            if axes:
                used.update(axes)
                entries.append(axes if len(axes) > 1 else axes[0])
            else:
                entries.append(None)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def split_axes(self, shape: tuple[int, ...],
                   logical_axes: tuple[Optional[str], ...]) -> tuple:
        """The mesh axes, in layout order, that a whole tensor of ``shape``
        is split over (``spec_for``'s); it is repeated over the others."""
        used = set()
        for entry in self.spec_for(tuple(shape), tuple(logical_axes)):
            if entry is not None:
                used.update((entry,) if isinstance(entry, str) else entry)
        return tuple(a for a in self.mesh.axis_names if a in used)

    def block(self, x: torch.Tensor,
              logical_axes: tuple[Optional[str], ...]) -> torch.Tensor:
        """This rank's block of the whole tensor ``x`` under its logical
        axes: a view (``narrow`` along each sharded dim), no copy; of a
        ``Fused`` leaf split along its fused dim, the rank's block of each
        part, concatenated (a copy)."""
        if len(logical_axes) != x.dim():
            raise ValueError(f"logical axes {logical_axes} for a tensor of "
                             f"shape {tuple(x.shape)}")
        parts = getattr(logical_axes, "parts", 1)
        for dim, entry in enumerate(self.spec_for(tuple(x.shape),
                                                  logical_axes)):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            k = parts if dim == getattr(logical_axes, "dim", -1) else 1
            n = x.shape[dim] // k // self.axis_prod(axes)
            if n * k * self.axis_prod(axes) != x.shape[dim]:
                raise ValueError(f"{k} parts of dim {dim} of "
                                 f"{tuple(x.shape)} over {axes}")
            at = self.mesh.index(axes) * n
            if k == 1:
                x = x.narrow(dim, at, n)
            else:
                x = x.unflatten(dim, (k, -1)).narrow(dim + 1, at, n) \
                    .flatten(dim, dim + 1)
        return x

    def block_shape(self, shape, logical_axes) -> tuple:
        """The shape of this rank's block of a tensor of ``shape`` under
        ``logical_axes`` (the reference's ``NamedSharding.shard_shape``)."""
        out = list(shape)
        for dim, entry in enumerate(self.spec_for(tuple(shape),
                                                  tuple(logical_axes))):
            if entry is not None:
                out[dim] //= self.axis_prod(
                    (entry,) if isinstance(entry, str) else entry)
        return tuple(out)

    def dim_block(self, shape, logical_axes, dim: int) -> tuple:
        """(start, size, axes): this rank's block of dim ``dim`` of a
        whole tensor of ``shape`` under ``logical_axes``, and the mesh
        axes it is split over (``()``, start 0 and the whole extent when
        the dim is whole: an axis the mesh lacks, or the divisibility
        fallback)."""
        entry = dict(enumerate(self.spec_for(tuple(shape),
                                             tuple(logical_axes)))).get(dim)
        whole = shape[dim]
        if entry is None:
            return 0, whole, ()
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n = whole // self.axis_prod(axes)
        return self.mesh.index(axes) * n, n, axes


def rank_block(x: torch.Tensor, dim: int, whole: int,
               axes: tuple[str, ...], ctx: ShardCtx) -> torch.Tensor:
    """``x`` as this rank's block of ``dim`` over ``axes``, where the whole
    extent is ``whole``: a whole tensor is narrowed to the block (a view),
    a block is returned as it is, and any other extent raises."""
    n = whole // ctx.axis_prod(axes)
    if x.shape[dim] == n:
        return x
    if x.shape[dim] == whole:
        return x.narrow(dim, ctx.mesh.index(axes) * n, n)
    raise ValueError(f"dim {dim} of extent {x.shape[dim]} is neither the "
                     f"whole {whole} nor a block of {n} over {axes}")


_TLS = threading.local()


def current_ctx() -> Optional[ShardCtx]:
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def sharding_ctx(mesh: Optional[Mesh], rules: Optional[dict] = None):
    """Install a sharding context; the mesh functions then run their
    ``shard_map`` bodies over its ranks."""
    prev = current_ctx()
    if mesh is None:
        _TLS.ctx = None
    else:
        merged = dict(DEFAULT_RULES)
        if rules:
            merged.update(rules)
        _TLS.ctx = ShardCtx(mesh, merged)
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = prev


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardCtx]):
    """Install ``ctx`` (a ``ShardCtx`` or None) as it is: for code that
    runs on another thread than the one that built it, such as a
    checkpointed body recomputed by the autograd engine's device thread
    (the context is thread-local)."""
    prev = current_ctx()
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


def axis_size(logical: str) -> int:
    """Product of mesh-axis sizes behind a logical axis (1 w/o ctx)."""
    ctx = current_ctx()
    if ctx is None:
        return 1
    return ctx.axis_prod(ctx.resolve(logical))


def mesh_axes(logical: str) -> tuple[str, ...]:
    ctx = current_ctx()
    if ctx is None:
        return ()
    return ctx.resolve(logical)


def local_params(tree, axes_tree, ctx: Optional[ShardCtx] = None):
    """This rank's blocks of a whole parameter tree: each leaf narrowed by
    its logical axes (``axes_tree``, e.g. ``models.model.mesh_logical_axes``,
    a tree of the same structure with a tuple of axis names per leaf) under
    ``ctx`` (default: the current context). Views, no copies, but for the
    split ``Fused`` leaves (``ShardCtx.block``). The counterpart of placing
    the tree with the reference's ``params_shardings``."""
    ctx = ctx or current_ctx()
    if ctx is None:
        raise ValueError("local_params needs a sharding context")
    if isinstance(tree, dict):
        return {k: local_params(v, axes_tree[k], ctx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [local_params(v, a, ctx) for v, a in zip(tree, axes_tree)]
    return ctx.block(tree, axes_tree)


def split_axes_tree(like, axes_tree, ctx: Optional[ShardCtx] = None) -> dict:
    """path -> the mesh axes each leaf of the whole tree ``like`` (tensors
    of the whole shapes, e.g. on the ``meta`` device) is split over under
    its logical axes (``axes_tree``), paths as ``models.params.tree_paths``
    names them. What a sharded train step reads to sum a gradient over the
    axes its leaf is repeated on, and a norm over those it is split on."""
    from ..models.params import tree_paths
    ctx = ctx or current_ctx()
    axes = dict(tree_paths(axes_tree, is_leaf=lambda x: isinstance(
        x, tuple) and all(a is None or isinstance(a, str) for a in x)))
    return {path: ctx.split_axes(tuple(t.shape), axes[path])
            for path, t in tree_paths(like)}
