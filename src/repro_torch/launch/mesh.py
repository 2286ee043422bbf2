"""Production meshes (``repro.launch.mesh``'s counterpart).

Functions, never module-level meshes, so importing this module touches no
process group.  A mesh is the port's :class:`~repro_torch.core.device_order.Mesh`
over ranks 0..n-1 of the process group, which must hold exactly n ranks:
a mesh is never shrunk to fit a smaller world.  The hardware constants of
the roofline analysis live in :mod:`repro_torch.launch.roofline`.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.device_order import Mesh


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a {shape} mesh over {axes} needs {n} ranks; the process group "
                         f"has {world}")
    return Mesh(np.arange(n).reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 256 ranks as (data=16, model=16).  Multi-pod: 2 pods of
    256 as (pod=2, data=16, model=16)."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """A small mesh for tests (8 gloo ranks on the CPU for the default)."""
    return _mesh(tuple(shape), tuple(axes))


def _backend(device: torch.device) -> str:
    """The process-group backend for ``device``: NCCL for CUDA, gloo for the CPU."""
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(device.type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {device}")
    return backend


def init_world(device: torch.device) -> int:
    """Joins the process group ``torch.distributed.run`` describes in the
    environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), with NCCL for a
    CUDA ``device`` and gloo for the CPU, and returns the world size; 1,
    with no process group, where that environment is absent (the GSPMD
    trainer then joins :func:`one_rank_world`).  On CUDA each rank takes card
    ``LOCAL_RANK``: NCCL does not put two ranks on one card, so more ranks
    than cards raise."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return dist.get_world_size() if dist.is_initialized() else 1
    backend = _backend(device)
    if backend == "nccl":
        local = int(os.environ["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local} has no card of its own "
                               f"({torch.cuda.device_count()} cards): NCCL takes one rank a card")
        torch.cuda.set_device(local)
    dist.init_process_group(backend)
    return dist.get_world_size()


def one_rank_world(device: torch.device) -> bool:
    """Joins a process group of one rank (NCCL for a CUDA ``device``, gloo
    for the CPU) over an in-process store, so no port is opened, unless a
    group exists; returns whether it made one."""
    if dist.is_initialized():
        return False
    backend = _backend(device)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device())
                            if backend == "nccl" else None)
    return True


def fake_world(n: int) -> bool:
    """Joins a process group of ``n`` ranks as rank 0 on PyTorch's ``"fake"``
    backend, whose collectives move nothing, so one process can run the
    production mesh (the dry run, ``launch.dryrun``); does nothing where a
    group of ``n`` ranks exists, and raises where one of another size does.
    Returns whether it made one."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"a process group of {dist.get_world_size()} ranks exists; "
                             f"the fake world needs {n}")
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return True
