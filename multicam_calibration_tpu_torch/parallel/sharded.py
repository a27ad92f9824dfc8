"""Frame-sharded LM bundle adjustment and points-sharded triangulation.

Counterpart of ``multicam_calibration_tpu/parallel/sharded.py``. JAX runs
one ``shard_map`` program over a device mesh; here every process of the
mesh runs the port's host LM loop on its contiguous slice of the frames
(poses and observations sharded, camera parameters replicated), and
``lm_solve`` all-reduces over the mesh's group at each of the JAX engine's
``psum`` points: the cost of every try, U and g_cam, the Schur system's
S_cross and rhs_cross, and the gradient norm, gain ratio and step norm. A
decision the host loop reads (accept, stop, damping) comes out of an
all-reduce, and the replicated 12C x 12C solve sees the same system on
every rank, so the ranks take the same branches and return the same
cameras and info. On CUDA tensors each rank's block build and per-try cost
run the BA kernels on its own frames.
"""
from __future__ import annotations

import torch

from ..models.lm_core import LMOptions, _pad_frames, lm_solve
from ..ops.triangulation import _prep_triangulate_inputs, _triangulate_impl
from .collectives import all_gather, process_group, rank_and_size
from .mesh import make_frame_mesh

__all__ = ["sharded_lm_solve", "sharded_triangulate"]


def _is_dtensor(x):
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _local_slice(x, axis, rank, n, fill):
    """Rank ``rank``'s contiguous share of ``x`` along ``axis`` when that
    axis is padded with ``fill`` to a multiple of ``n``."""
    size = x.shape[axis]
    per = -(-size // n)
    lo = min(rank * per, size)
    part = x.narrow(axis, lo, min(per, size - lo))
    missing = per - part.shape[axis]
    if not missing:
        return part
    if fill == 0:
        return _pad_frames(part, axis, missing)
    shape = list(part.shape)
    shape[axis] = missing
    return torch.cat([part, part.new_full(shape, fill)], dim=axis)


def sharded_lm_solve(
    cam_params,
    pose_params,
    obs,
    mask,
    objpoints,
    opts: LMOptions = LMOptions(),
    mesh=None,
    axis_name="frames",
    cam_free=None,
    init_lam=None,
    init_grad0=None,
):
    """Run lm_solve with the frames sharded over ``mesh[axis_name]``.

    Takes the global arrays, as the JAX function does, on every rank: the
    frames are zero-padded to a multiple of the mesh size with all-False
    masks (a padded frame's pose blocks are identity-padded in the Schur
    solve and get exactly zero updates; its zero pose puts the board at
    z = 0, where the projection takes its guarded branch), and each rank
    solves its contiguous slice. The output of :func:`shard_ba_inputs`
    (DTensors, already padded and placed) is taken as it is. ``mesh`` is a
    1-D ``DeviceMesh`` (or a process group); None makes one over every
    rank on the parameters' device. Returns ``(cam, poses, info)`` on every
    rank: the poses all-gathered, cut to the frames given; ``info`` as
    ``lm_solve``'s, the same on every rank.
    """
    if mesh is None:
        mesh = make_frame_mesh(axis_name=axis_name, device=cam_params.device)
    group = process_group(mesh, axis_name)
    rank, n = rank_and_size(group)
    F = pose_params.shape[0]
    if _is_dtensor(pose_params):
        poses_l, obs_l, mask_l = (x.to_local() for x in (pose_params, obs, mask))
    else:
        poses_l = _local_slice(pose_params, 0, rank, n, 0)
        obs_l = _local_slice(obs, 1, rank, n, 0)
        mask_l = _local_slice(mask, 1, rank, n, 0)
    cam, poses_l, info = lm_solve(
        cam_params, poses_l, obs_l, mask_l, objpoints, opts, cam_free=cam_free,
        axis_name=group, init_lam=init_lam, init_grad0=init_grad0,
    )
    return cam, all_gather(poses_l, group)[:F], info


def sharded_triangulate(
    all_uvs,
    all_extrinsics,
    all_intrinsics,
    mesh=None,
    axis_name="points",
    refine=True,
    return_sd=False,
    device=None,
):
    """Points-sharded robust triangulation for large keypoint clouds.

    Same arguments, semantics and returns as :func:`..ops.triangulation.
    triangulate` (``refine``, ``return_sd``, ``device``), with the points of
    the (C, n_points, 2) observations sharded over ``mesh[axis_name]``
    (None: a mesh over every rank on the data's device). Every stage is
    elementwise over points, so each rank triangulates its contiguous,
    NaN-padded slice with no collective, and one all-gather returns the
    whole result, trimmed, on every rank.
    """
    refine = refine or return_sd
    uvs, Ks, dists, exts, r2_maxs = _prep_triangulate_inputs(
        all_uvs, all_extrinsics, all_intrinsics, device
    )
    if uvs.ndim != 3:
        raise ValueError("sharded_triangulate expects (C, n_points, 2) observations")
    if mesh is None:
        mesh = make_frame_mesh(axis_name=axis_name, device=uvs.device)
    group = process_group(mesh, axis_name)
    rank, n = rank_and_size(group)
    local = _local_slice(uvs, 1, rank, n, float("nan"))
    out = _triangulate_impl(local, Ks, dists, exts, r2_maxs, refine=refine)
    if refine:
        out = torch.cat(out, dim=-1)  # (n_local, 6): points, sds
    out = all_gather(out, group)[: uvs.shape[1]]
    if not refine:
        return out
    pts, sd = out[:, :3], out[:, 3:]
    return (pts, sd) if return_sd else pts
