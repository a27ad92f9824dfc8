"""Calibration I/O and the config tree of the port vs the JAX package.

Calibration files: a calibration saved by either package loads in the
other, in the JSON, JARVIS (OpenCV YAML) and GIMBAL (HDF5) formats. Both
packages convert rotations with their own SO(3) exp/log in f64, so every
loaded value equals the saved one, and the other package's reading of the
same file, to 1e-12 (absolute; the values are O(1) rotations, O(100) mm
translations and O(1000) px focal lengths, and JSON, cv2.FileStorage and
HDF5 all store doubles exactly or to 17 significant digits). The JSON keys
match the JAX package's. Without ``h5py`` the GIMBAL format raises
ImportError naming h5py.

Config: the defaults, the YAML round trip and the override rules equal
the JAX package's; a YAML file written by either package loads in the
other.
"""
import builtins
import dataclasses
import json

import numpy as np
import pytest

from multicam_calibration_tpu.utils import config as jcfg
from multicam_calibration_tpu.utils import io as jio
from multicam_calibration_tpu_torch.utils import config as tcfg
from multicam_calibration_tpu_torch.utils import io as tio

ATOL = 1e-12
FORMATS = ("json", "jarvis", "gimbal")


@pytest.fixture(scope="module")
def calib():
    rng = np.random.default_rng(5)
    n = 4
    ext = np.concatenate([rng.uniform(-1.0, 1.0, (n, 3)), rng.uniform(-500, 500, (n, 3))], 1)
    intr = []
    for _ in range(n):
        K = np.array([[900 + rng.uniform(-5, 5), 0, 640 + rng.uniform(-8, 8)],
                      [0, 900 + rng.uniform(-5, 5), 512 + rng.uniform(-8, 8)], [0, 0, 1.0]])
        dist = np.array([rng.uniform(-0.2, 0), rng.uniform(0, 0.05), 0, 0, 0])
        intr.append((K, dist))
    return ext, intr, [f"cam{i}" for i in range(n)]


def _path(tmp_path, fmt, who):
    base = str(tmp_path / f"{who}_{fmt}")
    return base, base + {"json": ".json", "jarvis": "", "gimbal": ".h5"}[fmt]


def _assert_calibration(got, ext, intr, names):
    ext2, intr2, names2 = got
    assert list(names2) == list(names)
    np.testing.assert_allclose(np.asarray(ext2), ext, rtol=0, atol=ATOL)
    for (K2, d2), (K, d) in zip(intr2, intr):
        np.testing.assert_allclose(np.asarray(K2), K, rtol=0, atol=ATOL)
        np.testing.assert_allclose(np.asarray(d2).reshape(-1), d, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("saver,loader", [("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
def test_calibration_files_cross_load(calib, tmp_path, fmt, saver, loader):
    ext, intr, names = calib
    save = {"torch": tio.save_calibration, "jax": jio.save_calibration}[saver]
    load = {"torch": tio.load_calibration, "jax": jio.load_calibration}[loader]
    base, path = _path(tmp_path, fmt, saver)
    save(ext, intr, names, base, save_format=fmt)
    _assert_calibration(load(path, load_format=fmt), ext, intr, names)


@pytest.mark.parametrize("fmt", FORMATS)
def test_both_loaders_read_one_file_alike(calib, tmp_path, fmt):
    ext, intr, names = calib
    base, path = _path(tmp_path, fmt, "torch")
    tio.save_calibration(ext, intr, names, base, save_format=fmt)
    sub = [names[2], names[0]] if fmt != "json" else None
    e_t, i_t, n_t = tio.load_calibration(path, load_format=fmt, camera_names=sub)
    e_j, i_j, n_j = jio.load_calibration(path, load_format=fmt, camera_names=sub)
    assert list(n_t) == list(n_j)
    np.testing.assert_allclose(np.asarray(e_t), np.asarray(e_j), rtol=0, atol=ATOL)
    for (Kt, dt), (Kj, dj) in zip(i_t, i_j):
        np.testing.assert_allclose(Kt, Kj, rtol=0, atol=ATOL)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=ATOL)


def test_json_keys_and_values_match_jax(calib, tmp_path):
    ext, intr, names = calib
    tio.save_calibration(ext, intr, names, str(tmp_path / "t"), save_format="json")
    jio.save_calibration(ext, intr, names, str(tmp_path / "j"), save_format="json")
    got = json.load(open(tmp_path / "t.json"))
    ref = json.load(open(tmp_path / "j.json"))
    assert list(got) == list(ref)
    for name in ref:
        assert list(got[name]) == list(ref[name])
        for key in ref[name]:
            np.testing.assert_allclose(got[name][key], ref[name][key], rtol=0, atol=ATOL)


def test_tensor_inputs_save_like_numpy(calib, tmp_path):
    import torch

    ext, intr, names = calib
    tio.save_calibration(torch.as_tensor(ext), [(torch.as_tensor(K), torch.as_tensor(d))
                                                for K, d in intr],
                         names, str(tmp_path / "t"), save_format="json")
    _assert_calibration(jio.load_calibration(str(tmp_path / "t.json")), ext, intr, names)


def test_gimbal_without_h5py_raises_naming_it(calib, tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    ext, intr, names = calib
    with pytest.raises(ImportError, match="gimbal format needs h5py"):
        tio.save_calibration(ext, intr, names, str(tmp_path / "g"), save_format="gimbal")
    with pytest.raises(ImportError, match="gimbal format needs h5py"):
        tio.load_calibration(str(tmp_path / "g.h5"), load_format="gimbal")
    with pytest.raises(ValueError, match="Unknown format"):
        tio.save_calibration(ext, intr, names, str(tmp_path / "x"), save_format="csv")


def test_config_defaults_equal_jax():
    assert dataclasses.asdict(tcfg.PipelineConfig()) == dataclasses.asdict(jcfg.PipelineConfig())
    assert tcfg.__all__ == jcfg.__all__


@pytest.mark.parametrize("writer,reader", [(tcfg, jcfg), (jcfg, tcfg), (tcfg, tcfg)])
def test_config_yaml_cross_load(tmp_path, writer, reader):
    cfg = writer.PipelineConfig()
    cfg.ba.ftol = 1e-6
    cfg.ba.frame_chunk = 256
    cfg.board.shape = [6, 9]
    cfg.export.save_format = "jarvis"
    path = writer.save_config(cfg, str(tmp_path / "cfg.yaml"))
    got = reader.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(cfg)
    over = {"ba.max_iters": 7, "board.square_size": 10.0}
    assert (dataclasses.asdict(tcfg.load_config(path, over))
            == dataclasses.asdict(jcfg.load_config(path, over)))


def test_config_rejects_what_jax_rejects(tmp_path):
    bad_key = tmp_path / "bad.yaml"
    bad_key.write_text("ba:\n  not_a_field: 1\n")
    bad_sec = tmp_path / "sec.yaml"
    bad_sec.write_text("nope:\n  a: 1\n")
    for module in (tcfg, jcfg):
        with pytest.raises(ValueError, match="unknown keys"):
            module.load_config(str(bad_key))
        with pytest.raises(ValueError, match="unknown config sections"):
            module.load_config(str(bad_sec))
        with pytest.raises(ValueError, match="bad override key"):
            module.load_config(overrides={"ftol": 1.0})
