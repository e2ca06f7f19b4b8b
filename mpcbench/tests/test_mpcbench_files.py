"""The benchmark's files: every cell, configuration, traffic mix, limit
file and per-layer reader loads by name, and a cell can be added with new
files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from mpcbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    bench, c, cfg, traffic, limits = run.load_cell(cell)
    assert c["config"] == cfg["mpc"]["model_name"]
    assert traffic["driver"] in ("fleet", "planner")
    assert limits, "a cell compares at least one number"
    e2e = {m["name"] for m in run.cell_metrics(bench, c, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = run.cell_metrics(bench, c, "per_layer")
    assert layer
    for m in layer:
        run.load_reader(m)  # raises where the reader's constants differ


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("mpcbench/")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert run.reader_path(m["name"]).is_file()
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def test_a_cell_from_new_files_alone(tmp_path):
    """A new traffic mix and a new cell, as data: the harness finds both."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "mpcbench", tmp_path / "mpcbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = json.loads((tmp_path / "mpcbench/traffic/fleet-4096.json").read_text())
    traffic["batch"] = 2048
    (tmp_path / "mpcbench/traffic/fleet-2048.json").write_text(json.dumps(traffic))
    (tmp_path / "mpcbench/limits/panda-fleet-2048.json").write_text(
        (tmp_path / "mpcbench/limits/panda-fleet-4096.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "panda-fleet-2048", "config": "panda", "traffic": "fleet-2048",
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "panda-fleet-4096" in m["workloads"]:
            m["workloads"].append("panda-fleet-2048")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, cfg, traffic, limits = run.load_cell("panda-fleet-2048", root=tmp_path)
    assert traffic["batch"] == 2048 and cfg["mpc"]["model_name"] == "panda"
    assert {m["name"] for m in run.cell_metrics(bench, cell, "end_to_end")} == {
        "converged_solves_per_s", "setup_s"}
    for m in run.cell_metrics(bench, cell, "per_layer"):
        run.load_reader(m, root=tmp_path)


def test_a_metric_split_by_kind_shares_its_reader(tmp_path):
    """``idle_share.fleet`` reads ``metrics/idle_share.py``; a reader of the
    whole name, added as a new file, takes its place."""
    assert run.reader_path("idle_share.fleet") == ROOT / "mpcbench/metrics/idle_share.py"
    (tmp_path / "mpcbench/metrics").mkdir(parents=True)
    (tmp_path / "mpcbench/metrics/idle_share.py").write_text("")
    (tmp_path / "mpcbench/metrics/idle_share.group.py").write_text("")
    assert run.reader_path("idle_share.group", tmp_path).name == "idle_share.group.py"
    assert run.reader_path("idle_share.fleet", tmp_path).name == "idle_share.py"
