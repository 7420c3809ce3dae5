"""A CPU rehearsal of the harness's plumbing: every cell end to end at test
sizes, the result line, the readers, and the refusals."""
import json
import pathlib

import pytest

from gpubench import harness, run
from gpubench.tests.tiny import run_cell

# every cell the harness can find by name, in BENCHMARK.json or not yet
CELLS = sorted(p.stem for p in (pathlib.Path(harness.ROOT) / "workloads").glob("*.json"))
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_end_to_end_on_the_cpu(cell, trace):
    r = run_cell(cell, trace=trace)
    line = harness.result_line(r)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == set(r.workload["limits"])
    json.dumps(line)
    if not trace:
        assert set(line["metrics"]) == set(r.workload["end_to_end"])
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        # the CPU run has no device number: every reader declines
        assert line["metrics"] == {} and "breakdown" not in line
    for name in r.workload["per_layer"]:
        assert harness.reader(name)(r) is None


def test_the_harness_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""


def test_forbidden_modules_are_compared_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "ccst_tpu_torch_like", types.ModuleType("x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_loaded() == ["jax"]
