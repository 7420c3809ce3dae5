"""BENCHMARK.json against the files the harness finds by name, and the
contract's limits on names and sizes."""
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def load(kind, name):
    return json.loads((ROOT / "gpubench" / kind / f"{name}.json").read_text())


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 2 + 14 * 24 <= 43200 and (2 + 14 * 24) * (BENCH["run_seconds"] + 60) \
        + 24 * 180 + 1200 <= 43200


def test_names_units_and_lengths():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    for name in names:
        assert NAME.match(name), name
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"stylize_img_s", "stylize_batch_p95_ms", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_file_matches_benchmark_json(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    w = load("workloads", cell)
    assert {k: w[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert entry["chips"] == 1
    load("configs", w["config"])
    load("traffic", w["traffic"])
    assert (ROOT / "gpubench" / "drivers" / f"{load('traffic', w['traffic'])['driver']}.py"
            ).exists()
    assert "setup_s" in w["end_to_end"] and len(w["end_to_end"]) >= 2 and w["per_layer"]
    assert w["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_benchmark_json_lists_for_it(cell):
    w = load("workloads", cell)
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert w["units"] == {m: units[m] for m in w["end_to_end"] + w["per_layer"]}
    for m in BENCH["end_to_end"]:
        listed = "workloads" not in m or cell in m["workloads"]
        assert listed == (m["name"] in w["end_to_end"]), m["name"]
    for m in BENCH["per_layer"]:
        assert (cell in m["workloads"]) == (m["name"] in w["per_layer"]), m["name"]
        if m["name"] in w["per_layer"]:
            assert m["moves"] in w["end_to_end"]


ALL_CELLS = sorted(p.stem for p in (ROOT / "gpubench" / "workloads").glob("*.json"))


@pytest.mark.parametrize("metric", sorted({m for c in ALL_CELLS for m in load("workloads", c)["per_layer"]}
                                          | {m["name"] for m in BENCH["per_layer"]}))
def test_every_per_layer_metric_has_a_reader(metric):
    path = ROOT / "gpubench" / "metrics" / f"{metric}.py"
    assert path.exists()
    assert "def read(run)" in path.read_text()


def test_configs_name_their_files_and_reductions():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert c["file"].startswith("gpubench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_paths_and_command_stay_inside_the_benchmark():
    assert BENCH["paths"] == ["gpubench"]
    assert all(not a.startswith("/") and ".." not in a for a in BENCH["command"])
