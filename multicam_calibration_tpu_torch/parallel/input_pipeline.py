"""Multi-process input pipeline: per-process video decode + shard placement.

Counterpart of ``multicam_calibration_tpu/parallel/input_pipeline.py``.
Each process (rank of the default ``torch.distributed`` group) decodes and
detects only its assigned videos, the detections are exchanged once
(corner arrays, not frames) by all-reduces, and the BA inputs are placed
as DTensors sharded along the frame axis of a ``DeviceMesh``, each rank
holding its own frames. With one process (or no group) everything
degenerates to the local path.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_reduce, process_group, rank_and_size

__all__ = [
    "assign_videos_to_host",
    "gather_detections",
    "shard_ba_inputs",
    "distributed_calibration_detection",
]


def _world():
    """(rank, size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _reduce_host(array, op):
    """A numpy array reduced with ``op`` over the default group, through
    the group's device: the current CUDA device under NCCL, else the CPU."""
    group = dist.group.WORLD
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.as_tensor(np.ascontiguousarray(array), device=dev)
    return all_reduce(t, group, op).cpu().numpy()


def assign_videos_to_host(video_paths, process_index=None, process_count=None):
    """Deterministic round-robin split of videos across processes.

    Returns (my_paths, my_camera_indices). Every process computes the same
    global assignment, so camera ordering is stable without communication.
    Rank and size default to the default group's (0 and 1 without one).
    """
    rank, size = _world()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    mine = [(i, p) for i, p in enumerate(video_paths) if i % pc == pi]
    return [p for _, p in mine], [i for i, _ in mine]


def gather_detections(local_uvs, camera_indices, n_cameras, n_frames, n_points):
    """Assemble the global (n_cameras, n_frames, N, 2) detection array from
    per-process results.

    ``local_uvs``: (len(camera_indices), n_frames, N, 2) detections for this
    process's cameras. With more than one process, two all-reduce sums over
    the default group, of the NaN-zeroed corners and of their coverage,
    restore the slots no process filled to NaN.
    """
    out = np.full((n_cameras, n_frames, n_points, 2), np.nan)
    for row, cam in enumerate(camera_indices):
        out[cam] = local_uvs[row]
    if _world()[1] > 1:
        filled = _reduce_host(np.nan_to_num(out), dist.ReduceOp.SUM)
        cover = _reduce_host((~np.isnan(out)).astype(np.float32), dist.ReduceOp.SUM)
        out = np.where(cover > 0, filled / np.maximum(cover, 1), np.nan)
    return out


def shard_ba_inputs(obs, mask, poses, mesh, axis_name="frames"):
    """Place BA inputs with frame-axis sharding over ``mesh``.

    obs (C, F, N, 2) and mask (C, F, N) shard along F (``Shard(1)``), poses
    (F, 6) along F (``Shard(0)``): DTensors over the 1-D ``DeviceMesh``,
    each rank holding only its contiguous frame block, on the mesh's
    device. Frames are zero/False-padded to a multiple of the mesh size;
    padded frames carry all-False masks, so they are exactly inert in the
    solver. :func:`sharded_lm_solve` takes the result as it is.

    Returns (obs, mask, poses, n_frames_original).
    """
    from torch.distributed.tensor import DTensor, Shard

    rank, n = rank_and_size(process_group(mesh, axis_name))
    F = np.shape(poses)[0]
    pad = (-F) % n
    obs = np.asarray(obs)
    mask = np.asarray(mask)
    poses = np.asarray(poses)
    if pad:
        obs = np.concatenate(
            [obs, np.zeros((obs.shape[0], pad, *obs.shape[2:]), obs.dtype)], 1
        )
        mask = np.concatenate(
            [mask, np.zeros((mask.shape[0], pad, *mask.shape[2:]), bool)], 1
        )
        poses = np.concatenate([poses, np.zeros((pad, 6), poses.dtype)])
    per = (F + pad) // n
    sl = slice(rank * per, (rank + 1) * per)
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    def place(a, dim):
        local = torch.as_tensor(np.ascontiguousarray(a), device=dev)
        return DTensor.from_local(local, mesh, [Shard(dim)], run_check=False)

    return place(obs[:, sl], 1), place(mask[:, sl], 1), place(poses[sl], 0), F


def distributed_calibration_detection(
    video_paths, detection_fun=None, detection_options=None, **kwargs
):
    """Multi-process run_calibration_detection: each rank detects its videos.

    One process: identical to run_calibration_detection. More: each rank
    runs the SAME single-process pipeline on its assigned videos (local
    decode + local device, all of run_calibration_detection's cache/
    overwrite/alignment semantics), then all-reduces over the default group
    agree on the frame count (MIN), assemble the corners (two SUMs) and the
    image sizes (MAX). Returns (all_calib_uvs, img_sizes) on every rank.
    """
    from ..detection.detector import detect_chessboard
    from ..detection.video import run_calibration_detection

    detection_fun = detection_fun or detect_chessboard
    size = _world()[1]
    if size == 1:
        return run_calibration_detection(
            video_paths, detection_fun, detection_options, **kwargs
        )
    if size > len(video_paths):
        raise ValueError(
            f"{size} processes for {len(video_paths)} videos: "
            "every process must own at least one video"
        )
    my_paths, my_cams = assign_videos_to_host(video_paths)
    # Camera-indexed kwargs must be sliced to this rank's camera subset:
    # run_calibration_detection consumes them positionally (e.g.
    # aligned_frame_ixs[:, i] / all_frames[i] for LOCAL camera i), so
    # forwarding the global arrays would apply column i to global camera
    # my_cams[i].
    kwargs = dict(kwargs)
    if kwargs.get("aligned_frame_ixs") is not None:
        kwargs["aligned_frame_ixs"] = np.asarray(kwargs["aligned_frame_ixs"])[:, my_cams]
    if kwargs.get("all_frames") is not None:
        all_frames = kwargs["all_frames"]
        kwargs["all_frames"] = [all_frames[c] for c in my_cams]
    uvs_local, sizes_local = run_calibration_detection(
        my_paths, detection_fun, detection_options, **kwargs
    )
    # Agree on the global frame count (containers may differ across ranks).
    n_frames = int(_reduce_host(np.array([uvs_local.shape[1]], np.int64),
                                dist.ReduceOp.MIN)[0])
    uvs_local = uvs_local[:, :n_frames]
    uvs = gather_detections(
        uvs_local, my_cams, len(video_paths), n_frames, uvs_local.shape[2]
    )
    # Exchange image sizes (-1 padding + elementwise max across ranks).
    sizes = np.full((len(video_paths), 2), -1, np.int64)
    for row, cam in enumerate(my_cams):
        sizes[cam] = sizes_local[row]
    sizes = _reduce_host(sizes, dist.ReduceOp.MAX)
    return uvs, [tuple(int(v) for v in s) for s in sizes]
