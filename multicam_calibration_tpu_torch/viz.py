"""QC visualization: reprojection residuals, overlays, flatibration plots.

Counterpart of ``multicam_calibration_tpu/viz.py``. The accuracy metric
(:func:`compute_residual_metric`, the median reprojection error in
canonical board units) runs in torch on the device: the distortion-free
projection and ``undistort_points`` per camera, then one batched
``fit_homography`` / ``apply_homography`` over every (camera, frame) pair
and one ``masked_median`` per camera. The plots stay matplotlib on the host
and import it only when called; ``overlay_detections`` encodes through the
port's ``NativeVideoWriter`` or, where that is unavailable, imageio.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .device import resolve_device, with_highest_precision
from .models.bundle_adjustment import embed_calib_objpoints
from .ops.homography import apply_homography, fit_homography
from .ops.projection import project_points, undistort_points
from .ops.reductions import masked_median
from .utils.io import _host

__all__ = [
    "pad_axis_limits",
    "set_axis_limits",
    "compute_residual_metric",
    "plot_residuals",
    "overlay_detections",
    "visualize_flatibration",
    "plot_shared_detections",
    "plot_chessboard_qc_data",
]


def pad_axis_limits(xmin, xmax, ymin, ymax, pad=0.1):
    """Pad x/y limits by a fraction of their range."""
    x_range = xmax - xmin
    y_range = ymax - ymin
    return (
        xmin - pad * x_range,
        xmax + pad * x_range,
        ymin - pad * y_range,
        ymax + pad * y_range,
    )


def set_axis_limits(ax, data, pctl=1, pad=0.1):
    """Set axis limits from data percentiles."""
    xmin = np.nanpercentile(data[..., 0], pctl)
    xmax = np.nanpercentile(data[..., 0], 100 - pctl)
    ymin = np.nanpercentile(data[..., 1], pctl)
    ymax = np.nanpercentile(data[..., 1], 100 - pctl)
    xmin, xmax, ymin, ymax = pad_axis_limits(xmin, xmax, ymin, ymax, pad)
    ax.set_xlim(xmin, xmax)
    ax.set_ylim(ymin, ymax)


@with_highest_precision
def _residual_metric(uvs, extrinsics, Ks, dists, objpoints, pts_world):
    """The metric for every camera at once, on ``uvs``' device.

    ``uvs`` (C, F, N, 2), ``extrinsics`` (C, 6), ``Ks`` (C, 3, 3), ``dists``
    (C, D), ``objpoints`` (N, 3), ``pts_world`` (F, N, 3). As the JAX
    package (and the reference): reproject the consensus board points with
    a distortion-FREE projection, undistort the observed uvs, fit a
    per-frame homography observed -> canonical board, map the reprojections
    through it, and measure the distance to the canonical points; the
    median over each camera's frames with all corners seen.
    """
    reproj = torch.stack([
        project_points(pts_world, extrinsics[c], Ks[c], None) for c in range(len(uvs))
    ])  # (C, F, N, 2)
    und = torch.stack([
        undistort_points(uvs[c], Ks[c], dists[c]) for c in range(len(uvs))
    ])
    valid = torch.isfinite(und).all(dim=-1).all(dim=-1)  # (C, F)
    target = objpoints[:, :2]
    Hs = fit_homography(torch.nan_to_num(und), target.expand(und.shape))
    transformed = apply_homography(Hs, reproj)
    transformed = torch.where(valid[..., None, None], transformed, torch.nan)
    errors = torch.linalg.vector_norm(transformed - target, dim=-1)  # (C, F, N)
    med = masked_median(
        errors.flatten(1), valid[..., None].expand(errors.shape).flatten(1), axis=-1
    )
    return reproj, transformed, med


def compute_residual_metric(
    all_calib_uvs, all_extrinsics, all_intrinsics, calib_objpoints, calib_poses,
    device=None,
):
    """(median_error (C,), reprojections (C, F, N, 2),
    transformed_reprojections (C, F, N, 2)), numpy.

    The numeric core of ``plot_residuals`` without the figure: the
    framework's headline accuracy metric in board units (> ~1 indicates a
    failed calibration). Computed in f64 on ``device``; None means the CUDA
    device (raises without one).
    """
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(_host(a), dtype=torch.float64, device=dev)  # noqa: E731
    uvs = as_t(all_calib_uvs)
    objp = as_t(calib_objpoints)
    pts_world = embed_calib_objpoints(objp, as_t(np.nan_to_num(_host(calib_poses))))
    ext = torch.stack([as_t(e) for e in all_extrinsics])
    Ks = torch.stack([as_t(K) for K, _ in all_intrinsics])
    dists = torch.stack([as_t(d).reshape(-1) for _, d in all_intrinsics])
    reproj, transformed, med = _residual_metric(uvs, ext, Ks, dists, objp, pts_world)
    return _host(med), _host(reproj), _host(transformed)


def plot_residuals(
    all_calib_uvs,
    all_extrinsics,
    all_intrinsics,
    calib_objpoints,
    calib_poses,
    max_points=10000,
    marker_size=1,
    target_size=250,
    n_cols=3,
    inches_per_axis=5,
    hide_axes=True,
    device=None,
):
    """Reprojection-error QC figure.

    Returns (fig, median_error (C,), reprojections, transformed_reprojections).
    ``device`` as in :func:`compute_residual_metric`.
    """
    import matplotlib.pyplot as plt

    all_calib_uvs = np.asarray(all_calib_uvs)
    calib_objpoints = np.asarray(calib_objpoints)
    n_cameras = all_calib_uvs.shape[0]
    median_error, reprojections, transformed_reprojections = (
        compute_residual_metric(
            all_calib_uvs, all_extrinsics, all_intrinsics,
            calib_objpoints, calib_poses, device=device,
        )
    )

    n_rows = int(np.ceil(n_cameras / n_cols))
    fig, axes = plt.subplots(n_rows, n_cols, squeeze=False)
    axes = axes.reshape(-1)
    for cam in range(n_cameras):
        pts = transformed_reprojections[cam].reshape(-1, 2)
        plot_ixs = np.nonzero(~np.isnan(pts).any(-1))[0]
        if len(plot_ixs) > max_points:
            plot_ixs = np.random.choice(plot_ixs, max_points, replace=False)
        axes[cam].scatter(
            *calib_objpoints[:, :2].T, c="k", s=target_size, marker="+",
            linewidth=0.5,
        )
        axes[cam].scatter(*pts[plot_ixs].T, c="r", s=marker_size, linewidth=0)
        axes[cam].set_title(
            f"camera {cam} (median error={median_error[cam]:.2f})", fontsize=10
        )
        axes[cam].set_aspect("equal")
        if len(plot_ixs):
            set_axis_limits(axes[cam], pts[plot_ixs], pctl=1, pad=0.1)
        if hide_axes:
            axes[cam].axis("off")
    for i in range(n_cameras, n_rows * n_cols):
        axes[i].axis("off")
    aspect = np.ptp(calib_objpoints[:, 1]) / np.ptp(calib_objpoints[:, 0])
    fig.set_size_inches((n_cols * inches_per_axis, n_rows * inches_per_axis * aspect))
    return fig, median_error, reprojections, transformed_reprojections


# --- dependency-free frame drawing (numpy; no OpenCV required) -------------

_DIGIT_FONT = {  # 3x5 bitmaps, row-major strings
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001010010010", "8": "111101111101111",
    "9": "111101111001111",
}


def _draw_disk(frame, u, v, r, color):
    h, w = frame.shape[:2]
    y0, y1 = max(0, v - r), min(h, v + r + 1)
    x0, x1 = max(0, u - r), min(w, u + r + 1)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.ogrid[y0:y1, x0:x1]
    m = (yy - v) ** 2 + (xx - u) ** 2 <= r * r
    frame[y0:y1, x0:x1][m] = color


def _draw_line(frame, p1, p2, color, thickness=2):
    n = int(max(abs(p2[0] - p1[0]), abs(p2[1] - p1[1])) * 2 + 2)
    ts = np.linspace(0.0, 1.0, n)
    pts = np.rint(
        np.outer(1 - ts, np.asarray(p1, float))
        + np.outer(ts, np.asarray(p2, float))
    ).astype(int)
    r = max(1, thickness // 2)
    for u, v in np.unique(pts, axis=0):
        _draw_disk(frame, u, v, r, color)


def _draw_text(frame, text, origin, color, scale=2):
    u0, v0 = origin
    for k, ch in enumerate(str(text)):
        bits = _DIGIT_FONT.get(ch)
        if bits is None:
            continue
        for i in range(5):
            for j in range(3):
                if bits[i * 3 + j] == "1":
                    frame[
                        v0 + i * scale : v0 + (i + 1) * scale,
                        u0 + (k * 4 + j) * scale : u0 + (k * 4 + j + 1) * scale,
                    ] = color


def overlay_detections(
    video_path,
    detections=None,
    output_path=None,
    frame_range=None,
    overwrite=False,
    dotsize=3,
    draw_lines=True,
    frame_label_color=(0, 0, 255),
    frame_label_size=1,
    quality=6,
):
    """Render detections onto a video clip.

    Host-side IO: frames from ``detection.video.open_video``, encoded by the
    port's ``NativeVideoWriter`` when the native runtime is available, else
    by imageio; with neither this raises. Drawing is pure numpy —
    jet-colored dots, connecting lines, and a frame-index label, matching
    the reference's cv2 rendering. ``detections=None`` reads the video's
    ``{video}.detections.h5`` cache (needs ``h5py``).
    """
    import os

    import matplotlib.pyplot as plt

    from .detection.native_video import available as _native_ok
    from .detection.video import _h5py, open_video

    if detections is None:
        h5py = _h5py()
        detections_path = os.path.splitext(video_path)[0] + ".detections.h5"
        assert os.path.exists(detections_path), (
            f"No detections found at {detections_path}."
        )
        with h5py.File(detections_path, "r") as f:
            uvs = f["uvs"][()]
            frame_ixs = f["frame_ixs"][()]
            detections = {int(t): uvs[i] for i, t in enumerate(frame_ixs)}

    native = _native_ok()
    if not native:
        try:
            import imageio
        except ImportError as e:
            raise RuntimeError(
                "overlay_detections needs the native video runtime or imageio "
                "to encode; neither is available"
            ) from e

    reader = open_video(video_path)
    n_total = len(reader)
    fps = getattr(reader, "fps", 30) or 30

    if frame_range is None:
        start_frame, end_frame = 0, n_total
    else:
        start_frame, end_frame = frame_range
        assert start_frame < end_frame, "start_frame must be less than end_frame."

    if output_path is None:
        base_path = os.path.splitext(video_path)[0]
        output_path = f"{base_path}.overlay-{start_frame}-{end_frame}.mp4"
        print(f"Saving to {output_path}")
    assert (not os.path.exists(output_path)) or overwrite, (
        f'{output_path} already exists. Set "overwrite=True" to overwrite.'
    )

    first = np.asarray(reader[start_frame])
    h, w = first.shape[:2]
    if native:
        from .detection.native_video import NativeVideoWriter

        writer = NativeVideoWriter(output_path, w, h, fps=fps)
    else:
        writer = imageio.get_writer(
            output_path, pixelformat="yuv420p", fps=fps, quality=quality
        )

    label_scale = max(1, int(round(2 * frame_label_size)))
    try:
        for frame_ix in range(start_frame, end_frame):
            try:
                frame = (
                    first
                    if frame_ix == start_frame
                    else np.asarray(reader[frame_ix])
                )
            except IndexError:
                # Containers routinely over-report frame counts; finish with
                # the frames that exist (reference detection.py behavior).
                break
            if frame.ndim == 2:
                frame = np.repeat(frame[:, :, None], 3, axis=2)
            frame = np.ascontiguousarray(frame, np.uint8)
            if frame_ix in detections:
                uvs = detections[frame_ix]
                all_colors = plt.cm.jet(np.linspace(0, 1, len(uvs)))[:, :3] * 255
                # Keep each point's jet color tied to its corner index even
                # when some corners are NaN.
                positions, colors = [], []
                for (u, v), c in zip(uvs, all_colors):
                    if np.isfinite(u) and np.isfinite(v):
                        positions.append((int(u), int(v)))
                        colors.append((int(c[0]), int(c[1]), int(c[2])))
                if draw_lines:
                    for p1, p2, color in zip(positions[:-1], positions[1:], colors):
                        _draw_line(frame, p1, p2, color, 2)
                for (u, v), color in zip(positions, colors):
                    _draw_disk(frame, u, v, dotsize, color)
            _draw_text(
                frame, frame_ix, (20, h - 20 - 5 * label_scale),
                frame_label_color, label_scale,
            )
            writer.append_data(frame)
    finally:
        writer.close()
        if hasattr(reader, "close"):
            reader.close()
    return output_path


def visualize_flatibration(
    transform,
    floor_points,
    keypoints=None,
    max_points_to_plot=5000,
    figsize=(12, 6),
    axis_limits_pad=0.1,
    axis_limits_pctl=1,
):
    """2x2 before/after scatter of floor points (host, f64)."""
    import matplotlib.pyplot as plt

    from .ops.transforms import apply_rigid_transform

    def transformed(points):
        return apply_rigid_transform(
            torch.as_tensor(_host(transform), dtype=torch.float64),
            torch.as_tensor(points, dtype=torch.float64),
        ).numpy()

    fig, axs = plt.subplots(2, 2, figsize=figsize)
    if isinstance(floor_points, list):
        floor_points = np.concatenate(floor_points)
    floor_points = np.asarray(floor_points, dtype=float)
    if len(floor_points) > max_points_to_plot:
        ix = np.random.choice(len(floor_points), max_points_to_plot, replace=False)
        floor_points = floor_points[ix]

    set_lims = partial(set_axis_limits, pctl=axis_limits_pctl, pad=axis_limits_pad)

    axs[0, 0].scatter(*floor_points[:, [0, 2]].T, s=1, label="floor points", zorder=1)
    set_lims(axs[0, 0], floor_points[:, [0, 2]])
    axs[1, 0].scatter(*floor_points[:, [1, 2]].T, s=1, label="floor points", zorder=1)
    set_lims(axs[1, 0], floor_points[:, [1, 2]])

    fp_t = transformed(floor_points)
    axs[0, 1].scatter(*fp_t[:, [0, 2]].T, s=1, label="floor points", zorder=1)
    set_lims(axs[0, 1], fp_t[:, [0, 2]])
    axs[1, 1].scatter(*fp_t[:, [1, 2]].T, s=1, label="floor points", zorder=1)
    set_lims(axs[1, 1], fp_t[:, [1, 2]])

    if keypoints is not None:
        if isinstance(keypoints, list):
            keypoints = np.concatenate(keypoints)
        keypoints = np.asarray(keypoints, dtype=float).reshape(-1, 3)
        if len(keypoints) > max_points_to_plot:
            ix = np.random.choice(len(keypoints), max_points_to_plot, replace=False)
            keypoints = keypoints[ix]
        axs[0, 0].scatter(*keypoints[:, [0, 2]].T, s=1, label="keypoints", zorder=0)
        set_lims(axs[0, 0], keypoints[:, [0, 2]])
        axs[1, 0].scatter(*keypoints[:, [1, 2]].T, s=1, label="keypoints", zorder=0)
        set_lims(axs[1, 0], keypoints[:, [1, 2]])
        kp_t = transformed(keypoints)
        axs[0, 1].scatter(*kp_t[:, [0, 2]].T, s=1, label="keypoints", zorder=0)
        set_lims(axs[0, 1], kp_t[:, [0, 2]])
        axs[1, 1].scatter(*kp_t[:, [1, 2]].T, s=1, label="keypoints", zorder=0)
        set_lims(axs[1, 1], kp_t[:, [1, 2]])

    for ax in axs[:, 0]:
        ax.set_title("untransformed")
    for ax in axs[:, 1]:
        ax.set_title("transformed")
    for ax in axs[0]:
        ax.set_xlabel("x")
    for ax in axs[1]:
        ax.set_xlabel("y")
    for ax in axs.flat:
        ax.set_ylabel("z")
        ax.axhline(0, color="k", lw=1, zorder=2)
    plt.tight_layout()
    return fig


def plot_shared_detections(all_calib_uvs, spanning_tree, figsize=None):
    """Temporal coverage QC per spanning-tree edge.

    Answers the same question as the reference's shared-detection heatmap —
    when does each edge of the camera tree see the board
    in both of its cameras at once, and how much total support does each
    pairwise transform have — rendered as an event raster (left, one row
    per edge) with a per-edge coverage-count bar (right). Returns
    (fig, shared_detections (n_edges, n_frames) bool).
    """
    import matplotlib.pyplot as plt

    all_calib_uvs = np.asarray(all_calib_uvs)
    has_det = ~np.isnan(all_calib_uvs).any((-1, -2))  # (C, F)
    shared_detections = np.array(
        [has_det[c1] & has_det[c2] for c1, c2 in spanning_tree]
    )
    n_edges, n_frames = shared_detections.shape
    if figsize is None:
        figsize = (10, 0.45 * n_edges + 1.4)
    fig, (ax_raster, ax_bar) = plt.subplots(
        1, 2, figsize=figsize, sharey=True,
        gridspec_kw={"width_ratios": [4, 1]},
    )
    ax_raster.eventplot(
        [np.nonzero(row)[0] for row in shared_detections],
        lineoffsets=np.arange(n_edges), linelengths=0.8,
        colors="tab:blue", linewidths=0.5,
    )
    ax_raster.set_xlim(0, max(n_frames - 1, 1))
    ax_raster.set_xlabel("frame")
    ax_raster.set_yticks(np.arange(n_edges))
    ax_raster.set_yticklabels(
        [f"cam {c1} - cam {c2}" for c1, c2 in spanning_tree]
    )
    ax_raster.set_title("shared detections over time")
    counts = shared_detections.sum(1)
    ax_bar.barh(np.arange(n_edges), counts, color="tab:blue", height=0.7)
    for e, n in enumerate(counts):
        ax_bar.annotate(
            str(int(n)), (n, e), xytext=(3, 0), textcoords="offset points",
            va="center", fontsize=8,
        )
    ax_bar.set_xlabel("frames")
    ax_bar.set_title("coverage")
    fig.tight_layout()
    return fig, shared_detections


def plot_chessboard_qc_data(video_paths, figsize=None, gap_threshold=0.2):
    """Anchor-disambiguation QC per video.

    Same QC question as the reference's score heatmap/scatter figure: are the four anchor-match scores well separated
    enough for the orientation decision to be trustworthy? Re-expressed as,
    per video: (left) the four sorted scores traced over detected frames
    with the best/second-best margin shaded, (right) the distribution of
    that margin against the ``match_score_min_diff`` rejection threshold.
    Scores come from each video's ``{video}.detections.h5`` cache.
    """
    import os

    import matplotlib.pyplot as plt

    from .detection.video import _h5py

    h5py = _h5py()
    qc_datas = []
    for video_path in video_paths:
        detections_path = os.path.splitext(video_path)[0] + ".detections.h5"
        if not os.path.exists(detections_path):
            raise FileNotFoundError(
                f"Could not find {detections_path}. "
                "Run `run_calibration_detection` first."
            )
        with h5py.File(detections_path, "r") as h5:
            if "qc_data" not in h5:
                raise KeyError(
                    f"{detections_path} has no qc_data dataset — rerun "
                    "detection with reorder=True"
                )
            qc_datas.append(h5["qc_data"][:])

    n_videos = len(qc_datas)
    if figsize is None:
        figsize = (10, 2.4 * n_videos)
    fig, axs = plt.subplots(
        n_videos, 2, figsize=figsize, squeeze=False,
        gridspec_kw={"width_ratios": [2.5, 1]},
    )
    rank_labels = ["best", "2nd", "3rd", "4th"]
    for i, qc in enumerate(qc_datas):
        ax = axs[i, 0]
        frames = np.arange(len(qc))
        ax.fill_between(
            frames, qc[:, 1], qc[:, 0], color="tab:green", alpha=0.25,
            label="decision margin",
        )
        for j in range(qc.shape[1]):
            ax.plot(frames, qc[:, j], lw=0.7, label=rank_labels[j])
        ax.set_ylabel("anchor score")
        ax.set_title(os.path.basename(video_paths[i]), fontsize=10)
        if i == 0:
            ax.legend(fontsize=7, ncol=5, loc="lower right")
        if i == n_videos - 1:
            ax.set_xlabel("detected frame")

        axh = axs[i, 1]
        gaps = qc[:, 0] - qc[:, 1]
        axh.hist(gaps, bins=30, range=(0, 1), color="0.6")
        axh.axvline(
            gap_threshold, color="tab:red", ls="--", lw=1,
            label="rejection threshold",
        )
        if i == 0:
            axh.legend(fontsize=7)
        if i == n_videos - 1:
            axh.set_xlabel("best - 2nd margin")
        axh.set_ylabel("frames")
    fig.tight_layout()
    return fig
