"""Calibration persistence in the reference's three interchange formats.

Counterpart of ``multicam_calibration_tpu/utils/io.py``, file for file: a
calibration saved by either package loads in the other.

- ``json``  — one file, per-camera dict with R (3x3), T (3x1),
  camera_matrix, distortion_coefs, plus the same R and T under
  ``rotation`` / ``translation`` (the keys the reference's loader reads);
  the loader accepts either spelling.
- ``jarvis`` — directory of OpenCV-YAML files, one per camera, with the
  rotation/camera matrices TRANSPOSED (``cv2.FileStorage``).
- ``gimbal`` — single HDF5 with a camera_parameters group (``h5py``).

Rotations convert with the port's ``so3_exp`` / ``so3_log`` in f64 on the
CPU: this is host I/O, and no device is involved.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.rotation import so3_log
from ..ops.transforms import get_transformation_matrix

__all__ = ["save_calibration", "load_calibration"]


def require_h5py(what):
    """The h5py module; without it an ImportError saying that ``what``
    needs it (never a silent skip)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"{what} needs h5py, which is not installed") from e
    return h5py


def _host(x):
    """numpy view of an array or a tensor on any device."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rodrigues_inv_np(R):
    return so3_log(torch.as_tensor(np.asarray(R, dtype=np.float64))).numpy()


def _transforms_np(all_extrinsics):
    ext = torch.as_tensor(np.stack([_host(e) for e in all_extrinsics]).astype(np.float64))
    return get_transformation_matrix(ext).numpy()


def save_calibration(
    all_extrinsics, all_intrinsics, camera_names, save_path, save_format="json"
):
    """Save a calibration (the JAX package's signature and files)."""
    assert len(all_extrinsics) == len(all_intrinsics) == len(camera_names), (
        "Number of camera names must match number of extrinsics and intrinsics"
    )
    if save_format == "gimbal":
        h5py = require_h5py("the gimbal format")
    elif save_format not in ("json", "jarvis"):
        raise ValueError(f"Unknown format {save_format}")
    transforms = _transforms_np(all_extrinsics)

    if save_format == "json":
        data = {}
        for i, name in enumerate(camera_names):
            K = _host(all_intrinsics[i][0])
            dist = _host(all_intrinsics[i][1]).reshape(-1)
            R = transforms[i, :3, :3]
            T = transforms[i, :3, 3:]
            data[name] = {
                "R": R.tolist(),
                "T": T.tolist(),
                "rotation": R.tolist(),
                "translation": T.tolist(),
                "camera_matrix": K.tolist(),
                "distortion_coefs": dist.tolist(),
            }
        if not save_path.endswith(".json"):
            save_path += ".json"
        with open(save_path, "w") as f:
            json.dump(data, f, indent=4)

    elif save_format == "jarvis":
        import cv2

        os.makedirs(save_path, exist_ok=True)
        for i, name in enumerate(camera_names):
            fs = cv2.FileStorage(
                os.path.join(save_path, f"{name}.yaml"), cv2.FILE_STORAGE_WRITE
            )
            fs.write("intrinsicMatrix", _host(all_intrinsics[i][0]).T)
            fs.write(
                "distortionCoefficients",
                _host(all_intrinsics[i][1]).reshape(1, -1),
            )
            fs.write("R", transforms[i, :3, :3].T)
            fs.write("T", transforms[i, :3, 3:])
            fs.release()

    else:  # gimbal
        K = np.stack([_host(i[0]) for i in all_intrinsics])
        dist = np.stack([_host(i[1]).reshape(-1) for i in all_intrinsics])
        if not save_path.endswith(".h5"):
            save_path += ".h5"
        with h5py.File(save_path, "w") as h5:
            grp = h5.create_group("camera_parameters")
            grp.create_dataset("dist_coefs", data=dist)
            grp.create_dataset("intrinsic", data=K)
            grp.create_dataset("rotation", data=transforms[:, :3, :3])
            grp.create_dataset("translation", data=transforms[:, :3, 3])
            grp.create_dataset("camera_names", data=camera_names)


def load_calibration(load_path, load_format="json", camera_names=None):
    """Load a calibration (the JAX package's signature and returns):
    (all_extrinsics: list of (6,), all_intrinsics: list of (camera_matrix,
    dist_coefs), camera_names)."""
    if load_format == "json":
        with open(load_path) as f:
            data = json.load(f)
        if camera_names is None:
            camera_names = sorted(data.keys())
        else:
            assert set(camera_names) == set(data.keys()), (
                "Camera names must match keys in calibration file"
            )
        all_extrinsics, all_intrinsics = [], []
        for name in camera_names:
            entry = data[name]
            R = np.array(entry.get("rotation", entry.get("R")))
            T = np.array(entry.get("translation", entry.get("T")))
            all_extrinsics.append(
                np.concatenate([_rodrigues_inv_np(R), T.reshape(-1)])
            )
            all_intrinsics.append(
                (
                    np.array(entry["camera_matrix"]),
                    np.array(entry["distortion_coefs"]),
                )
            )
        return all_extrinsics, all_intrinsics, camera_names

    elif load_format == "jarvis":
        import cv2

        yaml_files = [
            f
            for f in sorted(os.listdir(load_path))
            if os.path.splitext(f)[1] in (".yaml", ".YAML")
        ]
        names_to_files = {os.path.splitext(f)[0]: f for f in yaml_files}
        if camera_names is None:
            camera_names = sorted(names_to_files)
        else:
            assert set(camera_names) <= set(names_to_files), (
                "Camera names must be a subset of yaml files in calibration directory"
            )
        all_extrinsics, all_intrinsics = [], []
        for name in camera_names:
            fs = cv2.FileStorage(
                os.path.join(load_path, names_to_files[name]),
                cv2.FILE_STORAGE_READ,
            )
            all_extrinsics.append(
                np.concatenate(
                    [
                        _rodrigues_inv_np(fs.getNode("R").mat().T),
                        fs.getNode("T").mat().reshape(-1),
                    ]
                )
            )
            all_intrinsics.append(
                (
                    fs.getNode("intrinsicMatrix").mat().T,
                    fs.getNode("distortionCoefficients").mat().reshape(-1),
                )
            )
        return all_extrinsics, all_intrinsics, camera_names

    elif load_format == "gimbal":
        h5py = require_h5py("the gimbal format")
        if not load_path.endswith(".h5"):
            load_path += ".h5"
        with h5py.File(load_path, "r") as h5:
            grp = h5["camera_parameters"]
            h5_names = [n.decode("utf-8") for n in grp["camera_names"][()]]
            all_intrinsics = list(zip(grp["intrinsic"][()], grp["dist_coefs"][()]))
            all_extrinsics = np.concatenate(
                [_rodrigues_inv_np(grp["rotation"][()]), grp["translation"][()]],
                axis=1,
            )
        if camera_names is None:
            camera_names = h5_names
        else:
            assert set(camera_names) <= set(h5_names), (
                "Camera names must be a subset of names in calibration file"
            )
            ix = [h5_names.index(n) for n in camera_names]
            all_extrinsics = all_extrinsics[np.array(ix)]
            all_intrinsics = [all_intrinsics[i] for i in ix]
        return list(all_extrinsics), all_intrinsics, camera_names

    else:
        raise ValueError(f"Unknown format {load_format}")
