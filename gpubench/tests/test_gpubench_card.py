"""On the card: a short traced run of a stylize cell through the command the
driver runs, and the control at the cell's own size failing the cell's limit.

    python -m pytest gpubench/tests -q -m card
"""
import json
import os
import subprocess
import sys

import pytest

from gpubench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
def test_a_traced_stylize_run_reads_its_layers(cuda_device):
    cell = "stylize-ref-512-b32"
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", cell, "--seed", "2147483659",
         "--seconds", "3", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and 0 < line["device"]["busy_s"]
    assert line["device"]["busy_s"] <= line["device"]["window_s"]
    assert set(line["metrics"]) == set(harness.load("workloads", cell)["per_layer"])
    for name, m in line["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)


@pytest.mark.card
def test_the_control_fails_the_limit_at_the_cells_size(cuda_device):
    from gpubench import control

    r = harness.load_run("stylize-ref-512-b32", 2147483647, 0.0, False, cuda_device, 0.0)
    readings = control.stylize_readings(r)
    assert any(readings[name] > r.limit(name) for name in r.workload["limits"]), readings


@pytest.mark.card
def test_the_training_control_fails_a_limit_at_the_cells_size(cuda_device):
    from gpubench import control

    r = harness.load_run("fedavg-r50-222-b32", 2147483629, 0.0, False, cuda_device, 0.0)
    readings = control.train_readings(r)
    assert any(readings[f"control.{name}"] > r.limit(name)
               for name in ("loss_gap", "grad_gap", "update_gap_median"))
