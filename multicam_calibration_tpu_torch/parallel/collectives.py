"""The collectives of the sharded paths, over ``torch.distributed``.

The JAX package's ``lax.psum`` inside ``shard_map`` and its
``process_allgather`` between hosts become ``all_reduce`` and
``all_gather`` on a process group: one process per device, each holding
its shard. A group is given as a ``ProcessGroup`` or as a 1-D
``DeviceMesh`` (the counterpart of a ``jax.sharding.Mesh``), whose group
is taken.

NCCL reduces the card's memory in place and needs one card per rank.
Gloo reduces host memory: a CUDA tensor on a gloo group (several ranks on
one card, which NCCL refuses) goes through the host and comes back to its
device. Every call returns a new tensor and leaves its input untouched.
``all_reduce.calls`` / ``.bytes`` and ``all_gather.calls`` / ``.bytes``
count the calls and the bytes each rank contributes, so a run can show
what its collectives moved.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["process_group", "rank_and_size", "all_reduce", "all_gather"]


def process_group(axis, axis_name=None):
    """The ``ProcessGroup`` of ``axis``: a ``DeviceMesh``'s (its dimension
    ``axis_name``, or its only one) or the group itself."""
    if hasattr(axis, "get_group"):
        return axis.get_group(axis_name) if axis_name is not None else axis.get_group()
    return axis


def rank_and_size(axis, axis_name=None):
    """(this process's rank in ``axis``, the number of ranks in it)."""
    group = process_group(axis, axis_name)
    return dist.get_rank(group), dist.get_world_size(group)


def _host_staged(x, group):
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _source(x, group):
    """A contiguous copy of ``x`` where the group's backend reduces it."""
    x = x.detach()
    if _host_staged(x, group):
        return x.cpu().contiguous()
    return x.clone(memory_format=torch.contiguous_format)


def all_reduce(x, axis, op=dist.ReduceOp.SUM):
    """``x`` reduced with ``op`` (a sum by default) over the ranks of
    ``axis``, on ``x``'s device."""
    group = process_group(axis)
    y = _source(x, group)
    dist.all_reduce(y, op=op, group=group)
    all_reduce.calls += 1
    all_reduce.bytes += y.numel() * y.element_size()
    return y.to(x.device)


def all_gather(x, axis):
    """The ranks' ``x`` concatenated along dim 0 in rank order, on ``x``'s
    device; every rank's ``x`` has the same shape."""
    group = process_group(axis)
    src = _source(x, group)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    all_gather.calls += 1
    all_gather.bytes += src.numel() * src.element_size()
    return torch.cat(parts).to(x.device)


all_reduce.calls = all_reduce.bytes = 0
all_gather.calls = all_gather.bytes = 0
