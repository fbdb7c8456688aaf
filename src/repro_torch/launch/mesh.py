"""Mesh construction: the port of ``repro/launch/mesh.py``.

Single pod: 16 x 16 = 256 devices, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 devices, axes (pod, data, model); the pod axis
composes with data for batch/FSDP sharding.

The production meshes are descriptions for planning (``launch.dryrun``):
no process ever joins them.  The host and serve meshes are real
``DeviceMesh`` objects over the process group's world, one process a
device, as ``torchrun`` starts them:

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu --mesh
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import MeshSpec

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def init_distributed(device: DeviceLike = None) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device: NCCL on the card
    (``cuda:{LOCAL_RANK}`` unless ``device`` names one), gloo on the CPU.
    Raises where the environment lacks a variable; a group already up must
    use the backend the device needs."""
    missing = [v for v in _ENV if v not in os.environ]
    if missing and not dist.is_initialized():
        raise RuntimeError(
            f"no process group: {', '.join(missing)} unset — start the "
            "program with torchrun (python -m torch.distributed.run "
            "--nproc-per-node N ...) or set them")
    if device is None and torch.cuda.is_available():
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}, and a "
                f"{dev.type} device needs {backend}")
        return dev
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            device_id=dev if dev.type == "cuda" else None)
    return dev


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "launch.mesh.init_distributed() first")
    return dist.get_world_size()


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_host_mesh():
    """(world, 1) over every rank of the process group."""
    return _mesh((_world_size(), 1), ("data", "model"))


def make_serve_mesh(n_data: int = 0, n_model: int = 1):
    """Serve-time mesh: data-parallel by default, TP optional.

    The serve path splits request microbatches (and FSDP-shards estimator
    params) across ``data``; ``n_data=0`` takes every rank of the world
    that ``n_model`` leaves."""
    n = n_data or max(1, _world_size() // n_model)
    return _mesh((n, n_model), ("data", "model"))
