"""Meshes and the process group (the port of ``repro.launch.mesh``).

Functions only: importing this module starts nothing.

  * ``init_world(device)`` starts the process group if none is started:
    under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` set) it joins that world; otherwise it starts a world of
    one over an in-process store. The backend is NCCL for ``cuda`` and gloo
    for ``cpu``; nothing falls back from NCCL to gloo on the card.
  * ``make_host_mesh(model_axis, device)`` builds a ("data", "model")
    DeviceMesh over the whole world, (world / model_axis, model_axis).
  * ``make_production_mesh(multi_pod)`` builds the reference's production
    meshes, (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
    "model"): 256 or 512 ranks (a fake process group holds them in tests).
  * ``mesh_devices(mesh)`` counts a mesh's ranks.

Multi-rank training:

  torchrun --nproc-per-node N -m repro_torch.launch.train --model-axis M
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.forest_torch import resolve_device


def init_world(device: str | torch.device = "cuda") -> bool:
    """Start the process group for ``device`` if none is started; True if
    this call started it (the caller then destroys it)."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                     "MASTER_PORT")):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def make_host_mesh(model_axis: int = 1,
                   device: str | torch.device = "cuda") -> DeviceMesh:
    """("data", "model") mesh over every rank of the world, starting a
    world of one if none is started."""
    init_world(device)
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world's {n} ranks")
    return init_device_mesh(torch.device(device).type,
                            (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_devices(mesh) -> int:
    n = 1
    for s in tuple(mesh.shape):
        n *= s
    return n
