"""What ``BENCHMARK.json`` and the files beside it say about one cell.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``perfbench/configs/<config>.json``: the deployment's sizes and the
  guarantees it states;
- ``perfbench/traffic/<traffic>.json``: the mix's parameters, with ``job``
  naming the generator in ``perfbench/jobs/<job>.py`` that reads them;
- ``perfbench/workloads/<cell>.json``: the limits of the cell's
  correctness numbers;
- ``perfbench/metrics/<metric>.py``: a reader with ``read(ctx)``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def benchmark(root=ROOT):
    return _json(Path(root) / "BENCHMARK.json")


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, root=ROOT):
    """The cell ``name`` with its configuration, mix, limits and metrics."""
    root = Path(root)
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / "perfbench"
    config = _json(root / configs[w["config"]]["file"])
    mix = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    cell_file = _json(bench_dir / "workloads" / f"{name}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix,
        limits=cell_file["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def job_module(job):
    """``perfbench/jobs/<job>.py``: the generator that drives one entry point."""
    return importlib.import_module(f"perfbench.jobs.{job}")


def metric_reader(name, root=ROOT):
    """``read`` of ``perfbench/metrics/<name>.py`` (the name may hold dots)."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
