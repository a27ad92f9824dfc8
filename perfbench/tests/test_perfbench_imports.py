"""After a rehearsal of every cell at a tiny size on the CPU, neither JAX
nor the JAX package is loaded; and the references load nothing of the
program."""
import ast
import json
import pathlib
import subprocess
import sys

from perfbench.harness import spec

REHEARSAL = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.harness import core
from perfbench.tests.tiny import tiny
for cell in ("rig6.detect_mixed", "stage64.rolling", "stage64.ba"):
    assert "checks" in core.run_cell(cell, 5, 0.5, 1, "cpu", overrides=tiny(cell))
print(json.dumps(core.forbidden_modules()))
"""


def test_no_jax_after_a_rehearsal_of_every_cell():
    out = subprocess.run([sys.executable, "-c", REHEARSAL.format(root=str(spec.ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_references_import_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("multicam_calibration_tpu_torch", "multicam_calibration_tpu",
                                   "jax"), f"{path.name} imports {n}"
    code = ("import sys; sys.path.insert(0, %r); import perfbench.reference.ba, "
            "perfbench.reference.detect, perfbench.reference.rolling; print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    loaded = set(json.loads(out.stdout.replace("'", '"')))
    assert not loaded & {"multicam_calibration_tpu_torch", "multicam_calibration_tpu", "jax"}
    assert pathlib.Path(spec.BENCH_DIR / "reference").exists()
