"""The seam between the port's models and its hand-written kernels.

``ops/`` only launches kernels: no module under it imports ``models``, at
module level or inside a function (the models choose between a kernel and
its plain twin and call down). And every public kernel entry refuses CPU
tensors with a ``ValueError`` that names CUDA, before it builds or
launches anything, so no CPU run reaches a kernel by accident.
"""
import ast
import pathlib

import pytest
import torch

from multicam_calibration_tpu_torch.ops import ba_cuda, corner_cuda, pose_cuda
from multicam_calibration_tpu_torch.utils.metrics import metrics

OPS = pathlib.Path(ba_cuda.__file__).resolve().parent


def _imported_modules(tree):
    """Every module an import statement anywhere in ``tree`` names, as
    (level, dotted name) pairs; ``from . import x`` gives (1, "x")."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((0, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.module:
                yield node.level, node.module
            else:
                yield from ((node.level, a.name) for a in node.names)


def _names_models(level, name):
    """Whether an import from inside ``ops/`` reaches the package's ``models``."""
    parts = name.split(".")
    if level == 0:
        return parts[:2] == ["multicam_calibration_tpu_torch", "models"]
    return level >= 2 and parts[0] == "models"


def test_no_module_under_ops_imports_models():
    modules = sorted(OPS.glob("*.py"))
    assert {p.name for p in modules} >= {"_build.py", "ba_cuda.py", "corner_cuda.py",
                                         "pose_cuda.py"}
    assert _names_models(2, "models.lm_core") and _names_models(0, "multicam_calibration_tpu_torch.models")
    assert not _names_models(1, "rotation") and not _names_models(2, "utils.metrics")
    found = [(p.name, level, name) for p in modules
             for level, name in _imported_modules(ast.parse(p.read_text()))
             if _names_models(level, name)]
    assert found == []


def _ba_args():
    C, F, N = 2, 3, 4
    f64 = torch.float64
    return (torch.zeros((C, 12), dtype=f64), torch.zeros((F, 6), dtype=f64),
            torch.zeros((C, F, N, 2), dtype=f64), torch.ones((C, F, N), dtype=torch.uint8),
            torch.zeros((N, 3), dtype=f64))


def _pose_args():
    C, F, N = 2, 3, 4
    f64 = torch.float64
    return (torch.zeros((C, F, 6), dtype=f64), torch.zeros((C, 12), dtype=f64),
            torch.zeros((C, F, N, 2), dtype=f64), torch.ones((C, F), dtype=torch.bool),
            torch.zeros((N, 3), dtype=f64))


ENTRIES = {
    "ba_chunk_blocks": (ba_cuda.ba_chunk_blocks, _ba_args, "ba_blocks_kernel"),
    "ba_chunk_cost": (ba_cuda.ba_chunk_cost, _ba_args, "ba_cost_kernel"),
    "corner_response_peaks": (corner_cuda.corner_response_peaks,
                              lambda: (torch.zeros((1, 16, 16)),), "corner_peaks_kernel"),
    "corner_response_fused": (corner_cuda.corner_response_fused,
                              lambda: (torch.zeros((1, 16, 16)),), "corner_response_kernel"),
    "pose_gn_refine": (pose_cuda.pose_gn_refine, _pose_args, "pose_gn_kernel"),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_kernel_entry_refuses_cpu_tensors(entry):
    fn, args, kernel = ENTRIES[entry]
    before = metrics.stage_times.get(f"{kernel}.launches", 0)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args())
    assert metrics.stage_times.get(f"{kernel}.launches", 0) == before
