"""Analytic FLOP model for the Schur-LM bundle-adjustment iteration.

Counterpart of ``multicam_calibration_tpu/utils/flops.py``: the arithmetic
one ``lm_solve`` run issues, split by precision, so a benchmark can report
achieved FLOP/s and a roofline fraction beside its wall clock. The model is
the JAX package's; the peak table is the NVIDIA H100's.

Counting conventions (documented, deliberately simple):
- one fused multiply-add = 2 FLOPs;
- the projection forward model (SO(3) exp x2, two rigid transforms,
  distortion, K-projection) is ~PROJ_FLOPS per 3D point;
- a jacfwd tangent costs ~2x the primal;
- the block build runs DENSE over all C x F pairs (masked pairs still cost
  FLOPs — the model charges them, the `obs_per_s` metric doesn't).
"""
from __future__ import annotations

PROJ_FLOPS = 130  # per point: 2 rodrigues (~45 ea), 2 transforms, distort+K
TANGENTS = 18  # 12 camera + 6 pose jacfwd tangents

__all__ = [
    "lm_flop_model", "lm_flops_detail", "device_peak_flops", "PROJ_FLOPS",
]


def lm_flop_model(n_cameras, n_frames, n_points, n_iters, nfev,
                  jacobian="analytic"):
    """FLOPs for one lm_solve run, split by precision domain.

    ``n_iters`` outer iterations each build blocks once; ``nfev - 1``
    damping tries each run one Schur solve + one residual cost evaluation
    (nfev counts cost evals including the initial one). Returns a dict of
    FLOP counts: jac (runs in LMOptions.jac_dtype), rest in the data dtype.

    ``jacobian`` mirrors LMOptions.jacobian: the closed-form chain-rule
    Jacobian (lm_core._analytic_pred_and_jacs) costs ~2x the primal per
    point, vs the 18-tangent jacfwd's ~2x18 (each tangent ~2x the primal).
    The U/V/W assembly contractions are identical either way — only their
    batching (full-contraction einsums vs per-(c,f) matmuls) differs, which
    changes achieved rate, not the FLOP count.
    """
    C, F, N = n_cameras, n_frames, n_points
    tries = max(nfev - 1, n_iters)

    # --- per block build (once per outer iteration), dense over C x F ---
    primal = C * F * N * PROJ_FLOPS
    jac_mult = 2 if jacobian == "analytic" else 2 * TANGENTS
    jac = C * F * N * PROJ_FLOPS * jac_mult
    # masked einsums: U (12x12), V (6x6), W (12x6), g_cam, g_pose over the
    # (N, 2) residual axis -> 2 * (N*2) * (144 + 36 + 72 + 12 + 6)
    block_assembly = C * F * 2 * (N * 2) * 270

    # --- per Schur solve (once per damping try) ---
    v_inv = F * 4 * 6**3  # damped 6x6 Cholesky inverses (~4/3 n^3 x batch)
    wvinv = C * F * 2 * 12 * 6 * 6
    s_cross = C * C * F * 2 * 12 * 12 * 6  # the big reduction matmul
    rhs = C * F * 2 * 12 * 6
    cam_solve = 2 * (12 * C) ** 3 // 3  # dense Cholesky of S
    backsub = C * F * 2 * 12 * 6 + F * 2 * 36
    schur = v_inv + wvinv + s_cross + rhs + cam_solve + backsub

    # --- per cost evaluation (once per damping try + the initial one) ---
    cost_eval = C * F * N * (PROJ_FLOPS + 8)

    return {
        # Granular run totals so the caller can bucket by the dtype each
        # component actually runs in (LMOptions.jac/block/solve/cost_dtype).
        "jac_flops": n_iters * jac,
        "primal_flops": n_iters * primal,
        "assembly_flops": n_iters * block_assembly,
        "schur_flops": tries * schur,
        "cost_flops": (tries + 1) * cost_eval,
        "data_flops": (
            n_iters * (primal + block_assembly)
            + tries * schur
            + (tries + 1) * cost_eval
        ),
        "per_iter_total": jac + primal + block_assembly + schur + cost_eval,
    }


# Peak rates per device kind, FLOP/s: (f32, f64) outside the tensor cores,
# from NVIDIA's H100 SXM data sheet (67 TFLOP/s f32, 34 TFLOP/s f64; the
# figures chip_smoke.py's bounds use). Used only to put achieved FLOP/s in
# proportion as a roofline fraction.
_PEAKS = {
    "h100": (67e12, 34e12),
}


def device_peak_flops(device_kind: str):
    """(peak_f32, peak_f64) FLOP/s for a device kind (e.g.
    ``torch.cuda.get_device_name()``), or None for a kind not in the
    table. Hopper runs f64 natively, at about half its f32 rate."""
    kind = device_kind.lower()
    for key, peaks in _PEAKS.items():
        if key in kind:
            return peaks
    return None


def lm_flops_detail(n_cameras, n_frames, n_points, n_iters, nfev, wall_s,
                    device_kind, n_obs=None, jacobian="analytic",
                    mixed_f32=True):
    """Roofline summary dict for one measured lm_solve run.

    ``mixed_f32``: True for the f32 recipe (jac + assembly + Schur + cost
    in f32; primal/residual path in the data dtype f64), False for a pure
    data-dtype run.
    """
    fm = lm_flop_model(n_cameras, n_frames, n_points, n_iters, nfev,
                       jacobian=jacobian)
    total = fm["jac_flops"] + fm["data_flops"]
    if mixed_f32:
        f32 = (fm["jac_flops"] + fm["assembly_flops"] + fm["schur_flops"]
               + fm["cost_flops"])
    else:
        f32 = 0
    f64 = total - f32
    detail = {
        "model_tflops": round(total / 1e12, 4),
        "achieved_tflops_per_s": round(total / wall_s / 1e12, 4),
        "f32_fraction": round(f32 / total, 3),
        "device_kind": device_kind,
        "nfev": nfev,
        "jacobian": jacobian,
    }
    if n_obs is not None:
        detail["obs_iters_per_s_M"] = round(n_obs * n_iters / wall_s / 1e6, 3)
    peaks = device_peak_flops(device_kind)
    if peaks:
        t_roofline = f32 / peaks[0] + f64 / peaks[1]
        detail["roofline_fraction"] = round(t_roofline / wall_s, 6)
    return detail
