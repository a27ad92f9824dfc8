"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric loads by name, the file keeps the contract's shape, and a cell
or metric added as new files is picked up without editing any file."""
import json
import re
import shutil

import pytest

from perfbench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert spec.job_module(c.mix["job"]).Job
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names, f"{m['name']} moves a metric {cell} does not report"
        assert callable(spec.metric_reader(m["name"]))
    assert all(isinstance(v, (int, float)) for v in c.limits.values())


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1] == "perfbench/run.py"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (spec.ROOT / c["file"]).exists()
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert all(k in cfg for k in c["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    everything = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(NAME.match(x["name"]) for x in everything)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))


def test_added_files_are_picked_up(tmp_path):
    """A throwaway cell and metric, added as new files in a copy, load by
    name; no existing file changes."""
    shutil.copytree(spec.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    (tmp_path / "perfbench/traffic/rolling_wide.json").write_text(
        json.dumps({"job": "rolling", "batch": 16, "fill_updates": 16}))
    (tmp_path / "perfbench/workloads/stage64.rolling_wide.json").write_text(
        json.dumps({"limits": {"cost_gap": 1e-6}}))
    (tmp_path / "perfbench/metrics/rolling.jobs.py").write_text(
        "def read(ctx):\n    return ctx['jobs']\n")
    bench["workloads"].append({"name": "stage64.rolling_wide", "config": "stage64",
                               "traffic": "rolling_wide", "chips": 1, "why": "test"})
    p90 = next(m for m in bench["end_to_end"] if m["name"] == "update_p90_ms")
    p90["workloads"].append("stage64.rolling_wide")
    bench["per_layer"].append({"name": "rolling.jobs", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "harness",
                               "moves": "update_p90_ms", "workloads": ["stage64.rolling_wide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("stage64.rolling_wide", root=tmp_path)
    assert cell.mix["batch"] == 16 and cell.limits == {"cost_gap": 1e-6}
    assert [m["name"] for m in cell.end_to_end] == ["update_p90_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["rolling.jobs"]
    assert spec.metric_reader("rolling.jobs", root=tmp_path)({"jobs": 3}) == 3
    after = {p: p.read_bytes() for p in before}
    assert after == before
