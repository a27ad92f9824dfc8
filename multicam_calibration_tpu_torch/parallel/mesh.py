"""Device-mesh construction: the process group and its 1-D frame mesh."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["make_frame_mesh"]

# What a launcher (torchrun) puts in the environment of each process.
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def make_frame_mesh(n_devices=None, axis_name="frames", device=None):
    """1-D ``DeviceMesh`` named ``(axis_name,)`` over the first
    ``n_devices`` ranks (all by default) of the default process group.

    One process per device, as PyTorch runs collectives. The caller may set
    the group up first (``torch.distributed.init_process_group``, the
    counterpart of ``jax.distributed.initialize()``); otherwise it is set up
    here: from the launcher's environment (``torchrun``: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; the card is
    ``LOCAL_RANK``) or, with none, as a group of one process. The backend
    follows ``device``: NCCL on CUDA (None: the CUDA device, raising
    without one), gloo on the CPU. A group the caller made keeps its
    backend: gloo with CUDA tensors runs several ranks on one card, which
    NCCL refuses.
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if all(k in os.environ for k in _LAUNCHER_ENV):
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} for a group of {world} processes")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(axis_name,))
