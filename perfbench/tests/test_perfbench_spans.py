"""Every per-layer metric a cell lists reads a number in a traced run of the
cell at a tiny size: the program's spans and counters on the CPU, and on
the card the device-trace metrics besides."""
import pytest

from perfbench.harness import core, spec
from perfbench.tests.tiny import tiny

CELLS = ("rig6.detect_mixed", "stage64.rolling", "stage64.ba")
# The card's float32 recipe, which the CPU applies only when asked: with it
# ``bundle_adjust`` runs its float64 polish there too.
RECIPE = dict(block_dtype="float32", cost_dtype="float32", solve_dtype="float32",
              grad_dtype="float32", gtol_rel=1e-6, lambda_escalation=3.0)


def _read(cell, device, **extra):
    """Names of the cell's metrics that the traced run read, and those it
    should have."""
    result = core.run_cell(cell, 2**31 + 12345, 0.5, 1, device, overrides=tiny(cell, **extra))
    return set(result["metrics"]), spec.load_cell(cell).per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_program_metrics_read_on_the_cpu(cell):
    extra = {"bundle_adjust": {"lm_options": RECIPE}} if cell == "stage64.ba" else {}
    read, listed = _read(cell, "cpu", **extra)
    want = {m["name"] for m in listed if m["source"] != "device_trace"}
    assert want <= read, sorted(want - read)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_every_metric_reads_on_the_card(cell, cuda_device):
    read, listed = _read(cell, cuda_device)
    want = {m["name"] for m in listed}
    assert want <= read, sorted(want - read)
