"""Meshes of ranks over ``torch.distributed`` (PyTorch port of
``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the ``pod`` axis is an outer data-parallel axis and
an extra shard axis for the pooled Engram table.

``make_mesh`` needs a process group initialised by the caller
(``torch.distributed.init_process_group`` with this rank, the world size
and an address); it never makes a one-rank group by itself. Ranks are laid
out row-major over the axes, as ``jax.make_mesh`` lays out devices. The
mesh carries one process group per axis (``init_device_mesh``'s) and one
per tuple of two or more axes in layout order (the reference's collectives
over several axes act on their flattened product), each over the ranks
that share this rank's other coordinates.

Functions, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations

import itertools
import math

import torch.distributed as dist

from ..device import resolve_device
from ..sharding.rules import Mesh


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device=None) -> Mesh:
    """The mesh ``shape`` over ``axes`` of this process group's ranks, on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    shape, axes = tuple(shape), tuple(axes)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} for a world of "
                         f"{dist.get_world_size()} ranks")
    dev = resolve_device(device)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    coords = dict(zip(axes, dm.get_coordinate()))
    mesh = Mesh.of(shape, axes, coords=coords)
    groups = {(a,): dm.get_group(a) for a in axes}
    # every tuple of two or more axes, in layout order: one group per
    # setting of the other axes, created by every rank in the same order
    for n in range(2, len(axes) + 1):
        for sub in itertools.combinations(axes, n):
            rest = [a for a in axes if a not in sub]
            lists = []
            for fixed in itertools.product(*(range(mesh.shape[a])
                                             for a in rest)):
                at = dict(zip(rest, fixed))
                lists.append([_rank(mesh, {**at, **dict(zip(sub, c))})
                              for c in itertools.product(
                                  *(range(mesh.shape[a]) for a in sub))])
            groups[sub] = dist.new_subgroups_by_enumeration(lists)[0]
    mesh.groups = groups
    for sub, g in groups.items():
        got = dist.get_group_rank(g, dist.get_rank())
        if got != mesh.index(sub):
            raise RuntimeError(f"group over {sub}: group rank {got}, "
                               f"row-major index {mesh.index(sub)}")
    return mesh


def _rank(mesh: Mesh, coords: dict) -> int:
    acc = 0
    for a in mesh.axis_names:
        acc = acc * mesh.shape[a] + coords[a]
    return acc


def parse_mesh(spec: str, device=None) -> Mesh:
    """The reference's ``launch.train.parse_mesh`` of a spec:
    ``"data=4,model=2"`` -> that mesh over the process group's ranks, on
    ``device`` (``make_mesh``'s). The reference's other branch (no spec:
    every device on the data axis) has no counterpart: without
    ``--mesh`` the port's trainer starts no process group."""
    axes, sizes = [], []
    for part in spec.split(","):
        name, size = part.split("=")
        axes.append(name)
        sizes.append(int(size))
    return make_mesh(tuple(sizes), tuple(axes), device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def single_device_mesh(device=None) -> Mesh:
    return make_mesh((1, 1), ("data", "model"), device)
