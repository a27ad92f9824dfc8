"""PyTorch port vs the JAX package: rotation, transforms, projection and
the exact four-point homography.

Same numpy inputs (seeded) through both packages in f64 on the CPU,
including axis-angle vectors below the 1e-8 small-angle threshold. The two
implementations run the same formulas, so they agree to f64 rounding:
rtol 1e-12, with an absolute floor of 1e-14 times the magnitude of the
compared array for entries that are ~0.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multicam_calibration_tpu.ops import homography as jhom
from multicam_calibration_tpu.ops import projection as jproj
from multicam_calibration_tpu.ops import rotation as jrot
from multicam_calibration_tpu.ops import transforms as jtf
from multicam_calibration_tpu_torch.ops import homography as thom
from multicam_calibration_tpu_torch.ops import projection as tproj
from multicam_calibration_tpu_torch.ops import rotation as trot
from multicam_calibration_tpu_torch.ops import transforms as ttf

RTOL = 1e-12


def _close(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    atol = 1e-14 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=atol)


def _axis_angles(seed):
    """Random rotation vectors: generic, tiny (|r| < 1e-8) and exactly 0."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(40, 3)) * rng.uniform(0.01, 3.0, size=(40, 1))
    r[:8] *= 1e-10 / np.linalg.norm(r[:8], axis=-1, keepdims=True)
    r[8] = 0.0
    return r


@pytest.mark.parametrize("fn", ["skew", "so3_exp", "so3_left_jacobian"])
def test_rotation_fns_match_jax(fn):
    r = _axis_angles(0)
    _close(getattr(trot, fn)(torch.as_tensor(r)), getattr(jrot, fn)(jnp.asarray(r)))


def test_so3_log_matches_jax():
    """Round trip through so3_exp, incl. theta ~ 0 and theta near pi."""
    r = _axis_angles(1)
    r[9] = np.array([np.pi - 1e-3, 0.0, 0.0])
    R = np.array(jrot.so3_exp(jnp.asarray(r)))
    _close(trot.so3_log(torch.as_tensor(R)), jrot.so3_log(jnp.asarray(R)))


def test_transforms_match_jax():
    rng = np.random.default_rng(2)
    t6 = np.concatenate([_axis_angles(3)[:20], rng.normal(size=(20, 3)) * 100], -1)
    T = np.array(jtf.get_transformation_matrix(jnp.asarray(t6)))
    _close(ttf.get_transformation_matrix(torch.as_tensor(t6)), T)
    _close(
        ttf.get_transformation_vector(torch.as_tensor(T)),
        jtf.get_transformation_vector(jnp.asarray(T)),
    )
    pts = rng.normal(size=(20, 7, 3)) * 50
    for tf in (t6, T):  # 6-vector and 4x4 forms
        _close(
            ttf.apply_rigid_transform(torch.as_tensor(tf)[:, None], torch.as_tensor(pts)),
            jtf.apply_rigid_transform(jnp.asarray(tf)[:, None], jnp.asarray(pts)),
        )
    h = np.array(jtf.euclidean_to_homogenous(jnp.asarray(pts)))
    _close(ttf.euclidean_to_homogenous(torch.as_tensor(pts)), h)
    _close(
        ttf.homogeneous_to_euclidean(torch.as_tensor(h * 3.0)),
        jtf.homogeneous_to_euclidean(jnp.asarray(h * 3.0)),
    )


def _poses(seed, n=20):
    rng = np.random.default_rng(seed)
    return np.concatenate([_axis_angles(seed)[:n], rng.normal(size=(n, 3)) * 100], -1)


@pytest.mark.parametrize("fn", ["se3_inverse", "se3_inverse_vector", "se3_compose"])
def test_se3_fns_match_jax(fn):
    t1, t2 = _poses(7), _poses(8)
    if fn == "se3_inverse":
        T = np.array(jtf.get_transformation_matrix(jnp.asarray(t1)))
        _close(ttf.se3_inverse(torch.as_tensor(T)), jtf.se3_inverse(jnp.asarray(T)))
    elif fn == "se3_inverse_vector":
        _close(ttf.se3_inverse_vector(torch.as_tensor(t1)),
               jtf.se3_inverse_vector(jnp.asarray(t1)))
    else:
        _close(ttf.se3_compose(torch.as_tensor(t1), torch.as_tensor(t2)),
               jtf.se3_compose(jnp.asarray(t1), jnp.asarray(t2)))


def _camera(seed):
    rng = np.random.default_rng(seed)
    K = np.array([[900.0 + rng.normal() * 20, 0.3, 640.0 + rng.normal() * 5],
                  [0.0, 905.0 + rng.normal() * 20, 512.0 + rng.normal() * 5],
                  [0.0, 0.0, 1.0]])
    dist = np.array([-0.2, 0.03, 1e-3, -5e-4, 0.002])
    return K, dist


@pytest.mark.parametrize("n_coefs", [2, 5])
def test_distortion_matches_jax(n_coefs):
    rng = np.random.default_rng(4)
    xy = rng.uniform(-0.5, 0.5, size=(50, 2))
    _, dist = _camera(4)
    dist = dist[:n_coefs]
    xd = np.array(jproj.distort_normalized(jnp.asarray(xy), jnp.asarray(dist)))
    _close(tproj.distort_normalized(torch.as_tensor(xy), dist), xd)
    _close(
        tproj.undistort_normalized(torch.as_tensor(xd), dist),
        jproj.undistort_normalized(jnp.asarray(xd), jnp.asarray(dist)),
    )
    assert tproj.distortion_valid_r2(dist) == jproj.distortion_valid_r2(dist)


@pytest.mark.parametrize("fn", ["distort_points", "undistort_points"])
def test_pixel_distortion_matches_jax(fn):
    """Pixel-coordinate distortion and its fixed-iteration inverse, NaN rows
    (undetected corners) passing through."""
    rng = np.random.default_rng(9)
    K, dist = _camera(9)
    uv = rng.uniform(100, 1100, size=(4, 30, 2))
    uv[1, 3] = np.nan
    got = getattr(tproj, fn)(torch.as_tensor(uv), K, dist).numpy()
    ref = np.asarray(getattr(jproj, fn)(jnp.asarray(uv), jnp.asarray(K), jnp.asarray(dist)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    _close(np.nan_to_num(got), np.nan_to_num(ref))


def test_get_perspective_transform_matches_jax():
    rng = np.random.default_rng(10)
    src = rng.uniform(0, 100, size=(5, 4, 2))
    dst = src + rng.normal(size=src.shape) * 5
    got = thom.get_perspective_transform(torch.as_tensor(src), torch.as_tensor(dst))
    ref = np.asarray(jhom.get_perspective_transform(jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())
    mapped = thom.apply_homography(got, torch.as_tensor(src)).numpy()
    np.testing.assert_allclose(mapped, dst, atol=1e-9)  # exact through all 4 pairs


def test_pixel_normalization_matches_jax():
    rng = np.random.default_rng(5)
    K, _ = _camera(5)
    uv = rng.uniform(0, 1000, size=(30, 2))
    xy = np.array(jproj.normalize_points(jnp.asarray(uv), jnp.asarray(K)))
    _close(tproj.normalize_points(torch.as_tensor(uv), K), xy)
    _close(
        tproj.denormalize_points(torch.as_tensor(xy), K),
        jproj.denormalize_points(jnp.asarray(xy), jnp.asarray(K)),
    )


@pytest.mark.parametrize("with_dist", [True, False])
def test_project_points_matches_jax(with_dist):
    rng = np.random.default_rng(6)
    K, dist = _camera(6)
    ext = np.array([0.05, -0.1, 0.02, 10.0, -20.0, 30.0])
    pts = rng.normal(size=(6, 35, 3)) * 40 + np.array([0.0, 0.0, 600.0])
    d = dist if with_dist else None
    _close(
        tproj.project_points(torch.as_tensor(pts), ext, K, d),
        jproj.project_points(
            jnp.asarray(pts), jnp.asarray(ext), jnp.asarray(K),
            None if d is None else jnp.asarray(d),
        ),
    )
