"""Typed configuration tree + YAML front end.

Counterpart of ``multicam_calibration_tpu/utils/config.py`` (the port keeps
its own copy: importing that module would import the JAX package). Every
tunable of the pipeline lives in dataclasses, loadable from YAML and
consumed by the CLI; a YAML file written by either package loads in the
other.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = [
    "BoardConfig",
    "DetectionConfig",
    "InitConfig",
    "BAConfig",
    "ExportConfig",
    "PipelineConfig",
    "load_config",
    "save_config",
]


@dataclasses.dataclass
class BoardConfig:
    """Calibration target geometry (tutorial defaults: (5,7) x 12.5 mm)."""

    shape: Sequence[int] = (5, 7)  # (rows, cols) of interior corners
    square_size: float = 12.5  # mm


@dataclasses.dataclass
class DetectionConfig:
    scale_factor: float = 1.0
    match_score_min_diff: float = 0.2
    max_candidates: int = 160
    nms_radius: int = 4
    reorder: bool = True
    overwrite: bool = False


@dataclasses.dataclass
class InitConfig:
    root_camera: int = 0
    n_samples_for_intrinsics: int = 100


@dataclasses.dataclass
class BAConfig:
    n_frames: Optional[int] = 10000
    outlier_threshold: Optional[float] = None  # None -> 5 x median rule
    ftol: float = 1e-4
    loss: str = "soft_l1"
    f_scale: float = 1.0
    max_iters: int = 100
    dtype: str = "float32"  # compute dtype on device
    n_devices: Optional[int] = None  # None -> single device
    # Frames per linearization chunk (None = dense). Bounds LM peak memory
    # at O(C * frame_chunk) for very large problems (see LMOptions).
    frame_chunk: Optional[int] = None


@dataclasses.dataclass
class ExportConfig:
    save_format: str = "json"  # json | jarvis | gimbal
    save_path: str = "calibration"


@dataclasses.dataclass
class PipelineConfig:
    board: BoardConfig = dataclasses.field(default_factory=BoardConfig)
    detection: DetectionConfig = dataclasses.field(default_factory=DetectionConfig)
    init: InitConfig = dataclasses.field(default_factory=InitConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    export: ExportConfig = dataclasses.field(default_factory=ExportConfig)


_SECTIONS = {
    "board": BoardConfig,
    "detection": DetectionConfig,
    "init": InitConfig,
    "ba": BAConfig,
    "export": ExportConfig,
}


def load_config(path=None, overrides=None):
    """Build a PipelineConfig from YAML + dotted-key overrides.

    ``overrides``: dict like {"ba.ftol": 1e-6, "board.shape": [5, 7]}.
    """
    data = {}
    if path is not None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
    cfg = PipelineConfig()
    for section, cls in _SECTIONS.items():
        if section in data:
            known = {f.name for f in dataclasses.fields(cls)}
            unknown = set(data[section]) - known
            if unknown:
                raise ValueError(
                    f"unknown keys in config section '{section}': {sorted(unknown)}"
                )
            setattr(
                cfg, section,
                dataclasses.replace(getattr(cfg, section), **data[section]),
            )
    unknown_sections = set(data) - set(_SECTIONS)
    if unknown_sections:
        raise ValueError(f"unknown config sections: {sorted(unknown_sections)}")
    for key, value in (overrides or {}).items():
        section, _, field = key.partition(".")
        if section not in _SECTIONS or not field:
            raise ValueError(f"bad override key '{key}' (use section.field)")
        setattr(
            cfg, section,
            dataclasses.replace(getattr(cfg, section), **{field: value}),
        )
    return cfg


def save_config(cfg, path):
    import yaml

    data = {
        section: dataclasses.asdict(getattr(cfg, section))
        for section in _SECTIONS
    }
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
    return path
