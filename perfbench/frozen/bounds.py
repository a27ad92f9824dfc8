"""Frozen roofline arithmetic: the H100's published peaks and the least time
the port's CUDA kernels could take at a given shape.

Copied from ``chip_smoke.py`` (``HBM_BPS``, ``F32_FLOPS``, ``F64_FLOPS``,
``bound``, ``ba_bounds``, ``corner_bound``) at commit ab4aaad3d64c. The
peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: 3.35 TB/s
of HBM, 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the tensor cores.
"""
from __future__ import annotations

HBM_BPS, F32_FLOPS, F64_FLOPS = 3.35e12, 67e12, 34e12


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over their peak rate; ``ops`` is [(count, flop/s), ...]."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(n / rate for n, rate in ops)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ba_bounds(C, F, N, n_obs):
    """Bounds of the two BA kernels at one shape. Bytes: the parameters
    (C x 12, F x 6 f64), board points, observations (f64) and mask (u8)
    read once, the f32 outputs written once. Operations, counted for the
    observed points only: the f64 prediction chain, ~60 flops per point
    (rotate and translate twice, project, distort, scale), and for the block
    build the 189 distinct normal-block outputs, each a multiply-add over
    the point's two residual rows (756 f32 flops per point). The rotations
    of C + F parameter vectors are ~100 flops each and left out."""
    inputs = C * 12 * 8 + F * 6 * 8 + N * 3 * 8 + C * F * N * (2 * 8 + 1)
    blocks_out = 4 * (C * 144 + F * 36 + C * F * (72 + 12 + 6 + 1))
    chain = (60 * n_obs, F64_FLOPS)
    return {
        "ba_blocks_kernel": bound(inputs + blocks_out, [chain, (756 * n_obs, F32_FLOPS)]),
        "ba_cost_kernel": bound(inputs + 4 * C * F + 8, [chain, (4 * n_obs, F32_FLOPS)]),
    }


def corner_bound(B, H, W, sigma, nms, peaks):
    """Bound of the corner kernel on (B, H, W): 4 B read and 4 B (+1 B of
    peak) written per pixel; per pixel 2 (2 rg + 1) - 1 flops for each
    Gaussian pass, 12 for the stencil and response, 4 nms + 2 for the window
    max and the compare."""
    rg = int(3 * sigma + 0.5)
    px = B * H * W
    per_px = 2 * (2 * (2 * rg + 1) - 1) + 12 + (4 * nms + 2 if peaks else 0)
    return bound(px * (4 + 4 + (1 if peaks else 0)), [(px * per_px, F32_FLOPS)])
