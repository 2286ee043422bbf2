"""Mesh rank order from a TopoOpt plan (``repro.core.device_order``'s
counterpart).

On a reconfigurable fabric the paper *rewires* the physical topology to match
the chosen ring permutations.  Where the links are fixed, the *logical*
order of the ranks in a mesh is still free: permuting the rank axis so the
heaviest AllReduce ring becomes stride-1 in rank order realizes the same
co-optimization.

:class:`Mesh` is the port's ``jax.sharding.Mesh``: a grid of global ranks
with named axes.  A rank's place on an axis is its mesh coordinate, never its
rank in a process group: ``torch.distributed.new_group`` sorts its ranks, so
under a stride-reordered axis the group rank of a process is not its mesh
position.  The collectives (:mod:`repro_torch.core.collectives`) take the
position from :meth:`Mesh.axis` and address peers by the global rank at a
mesh position.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .totient import ring_order


def permuted_axis_order(n: int, p: int) -> list[int]:
    """Order ranks along an axis so the stride-``p`` logical ring maps to
    adjacent ranks: position j gets rank (j * p) % n."""
    return ring_order(n, p)


def reorder_mesh_devices(grid: np.ndarray, axis: int, p: int) -> np.ndarray:
    """Permute ``grid`` (an ndarray of ranks, mesh-shaped) along ``axis`` with
    the stride-``p`` ring order."""
    grid = np.asarray(grid)
    order = permuted_axis_order(grid.shape[axis], p)
    return np.take(grid, order, axis=axis)


def _world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class MeshAxis:
    """One axis of a mesh as this process sees it: ``ranks``, the global ranks
    along the axis line through this process in mesh order; ``index``, this
    process's position on it (``lax.axis_index``); ``group``, the process
    group of those ranks (None: the whole world) for plain collectives."""

    ranks: tuple[int, ...]
    index: int
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """A grid of global ranks with named axes.

    ``devices`` holds the ranks and ``shape`` maps each axis name to its size
    (as ``jax.sharding.Mesh.shape``).  The collectives pick the backend from
    the tensor they move (a CUDA tensor: NCCL, a CPU tensor: gloo).  With a
    process group of more than one rank, construction makes one group a line
    of every axis that does not span the world; every rank must construct
    the same mesh in the same order, as with any ``new_group``.  Under NCCL
    it then runs one all-reduce over the world: NCCL leaves a first
    ``batch_isend_irecv`` undefined unless every rank of the group takes
    part, and the first round of a tree or of a pipeline leaves ranks out.
    """

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} vs axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        rank, world = _world()
        if sorted(self.devices.flat) != list(range(self.devices.size)) or self.devices.size > world:
            raise ValueError(f"mesh ranks {self.devices.tolist()} vs a world of {world}")
        self._groups: dict[str, object] = {}
        for a, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, a, -1).reshape(-1, self.devices.shape[a])
            for line in lines:
                if world == 1 or sorted(line) == list(range(world)):
                    group = None
                else:
                    group = dist.new_group(sorted(int(r) for r in line))
                if rank in line:
                    self._groups[name] = group
        if world > 1 and dist.get_backend() == "nccl":
            dist.all_reduce(torch.zeros(1, device=torch.cuda.current_device()))

    def axis(self, name: str) -> MeshAxis:
        """The axis ``name`` as this process sees it."""
        rank, _ = _world()
        a = self.axis_names.index(name)
        coord = np.argwhere(self.devices == rank)[0]
        index = [slice(None) if i == a else int(c) for i, c in enumerate(coord)]
        ranks = tuple(int(r) for r in self.devices[tuple(index)])
        return MeshAxis(ranks, int(coord[a]), self._groups[name])


def topoopt_mesh(
    shape: tuple[int, ...],
    axis_names: tuple[str, ...],
    *,
    allreduce_axis: str = "data",
    stride: int = 1,
    devices: np.ndarray | None = None,
) -> Mesh:
    """A :class:`Mesh` whose ``allreduce_axis`` rank order realizes the chosen
    TotientPerms primary stride; ``devices`` defaults to ranks
    0..prod(shape)-1."""
    if devices is None:
        devices = np.arange(math.prod(shape))
    grid = np.asarray(devices).reshape(shape)
    if stride != 1:
        grid = reorder_mesh_devices(grid, axis_names.index(allreduce_axis), stride)
    return Mesh(grid, axis_names)
