"""Device meshes over ``torch.distributed`` ranks.

Counterpart of the reference package's ``launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's dim
names, ``("data", "model")`` or ``("pod", "data", "model")``, over the
ranks of the default process group: one process a rank, each holding its
own shard (SPMD by process, where the reference places shards on the
devices of one process).

The caller starts the ranks and initialises the process group; the one
exception is a 1 x 1 mesh, for which :func:`make_host_mesh` makes a
single-rank group itself (nccl on ``"cuda"``, gloo on ``"cpu"``).  NCCL
holds one rank per card, so several ranks sharing one card must use the
gloo backend; a mesh that would put more NCCL ranks than there are cards
is refused before any NCCL initialisation.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

#: every process group this package makes gives up on a dead peer after
#: this long instead of waiting on it for ever
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def _mesh(shape, axes, device_type: str):
    n = int(np.prod(shape))
    backend = (dist.get_backend() if dist.is_initialized()
               else "nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda" and "nccl" in str(backend):
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > cards:
            raise ValueError(
                f"mesh {shape} would put {n} NCCL ranks on {cards} CUDA "
                "device(s); NCCL holds one rank per card — start the ranks "
                "with the gloo backend to run several of them on one card")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"mesh {shape} needs {n} ranks, have 1 — start {n} "
                "processes and initialise their process group first "
                "(launch.ranks)")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=GROUP_TIMEOUT)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, have {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 ranks; 2 x 16 x 16 = 512 when ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device_type: str = "cuda"):
    """A ``data`` x ``model`` mesh over the ranks of the process group
    (``RuntimeError`` unless the world has ``data * model`` ranks)."""
    return _mesh((data, model), ("data", "model"), device_type)


def mesh_axes(mesh) -> dict:
    """``{dim name: size}``, in the mesh's dim order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> tuple:
    """Data-parallel axes: ('pod', 'data') multi-pod, ('data',) single-pod."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
