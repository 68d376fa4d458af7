"""BENCHMARK.json against the layout the harness reads: every file it names
is found by name, and the numbers keep to their limits."""

import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def load(path: Path) -> dict:
    return json.loads(path.read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


FILES = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def test_every_listed_cell_has_a_file():
    assert set(CELLS) <= set(FILES)


@pytest.mark.parametrize("cell", FILES)
def test_cell_files_found_by_name(cell):
    spec = load(HERE / "workloads" / f"{cell}.json")
    assert spec["name"] == cell and NAME.match(cell)
    entry = next((w for w in BENCH["workloads"] if w["name"] == cell), spec)
    assert spec["config"] == entry["config"]
    assert spec["traffic"] == entry["traffic"]
    assert spec["chips"] == entry["chips"] == 1
    assert (HERE / "configs" / f"{spec['config']}.json").is_file()
    mix = load(HERE / "traffic" / f"{entry['traffic']}.json")
    assert (HERE / "traffic" / f"{mix['kind']}.py").is_file()
    assert (HERE / "entries" / f"{mix['entry']}.py").is_file()
    assert mix["loop"] in ("closed", "pipelined")
    assert set(spec["checks"]) == {"mismatch_share", "rays_gap"}
    assert spec["compare_frames"] >= 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_found_by_name(config):
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    spec = load(ROOT / config["file"])
    assert spec["source"] == config["source"]
    assert spec["reduced"] == config["reduced"]
    assert set(spec["reduced"]) <= set(spec) and len(spec["reduced"]) <= 16
    assert (HERE / "scenes" / f"{spec['scene']}.py").is_file()
    assert (HERE / "reference" / f"{spec['reference']}.py").is_file()
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", ()):
        assert cell in CELLS


def test_names_and_pairs():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    def mine(ms):
        return [m for m in ms if cell in m.get("workloads", [cell])]

    e2e = [m["name"] for m in mine(BENCH["end_to_end"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = mine(BENCH["per_layer"])
    assert layer
    assert all(m["moves"] in e2e for m in layer)
