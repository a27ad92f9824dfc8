"""Distribution layer: process groups, device meshes, frame-sharded bundle
adjustment and the multi-process input pipeline, over ``torch.distributed``.

Counterpart of ``multicam_calibration_tpu/parallel/``. The scaling
dimension of calibration is the frame axis: pose blocks shard across
processes (one per device), camera blocks replicate, and each damping try
all-reduces the reduced (12C)^2 camera system, its right-hand side, U,
g_cam and the scalar cost. Run it under ``torchrun --nproc_per_node N``
(NCCL, one card per rank), or at one process with :func:`make_frame_mesh`
setting up a group of one.
"""
from .mesh import make_frame_mesh
from .sharded import sharded_lm_solve, sharded_triangulate
from .input_pipeline import (
    assign_videos_to_host,
    distributed_calibration_detection,
    gather_detections,
    shard_ba_inputs,
)

__all__ = [
    "make_frame_mesh",
    "sharded_lm_solve",
    "sharded_triangulate",
    "assign_videos_to_host",
    "distributed_calibration_detection",
    "gather_detections",
    "shard_ba_inputs",
]
