"""The control (the reference in the next precision below the
configuration's) reads well above what the sound program reads, at test size
on the CPU; on the card and at the cells' own size, ``gpubench.control``
gives the readings the limits are set from (``PERF.md``)."""
import time

import pytest
import torch

from gpubench import control, harness
from gpubench.tests.tiny import run_cell, scale_of

def numbers(r):
    """Every number a run worked out, compared or not."""
    return {**r.readings, **{c.name: c.value for c in r.checks}}


STYLIZE = ["stylize-ref-512-b32", "stylize-int8fused-512-b32", "stylize-single-ref-512-b32"]


@pytest.mark.parametrize("cell", STYLIZE)
def test_the_stylize_control_reads_three_times_the_program_on_a_compared_number(cell):
    seed = 2**31 + 29
    sound = numbers(run_cell(cell, seed=seed))
    r = harness.load_run(cell, seed, 0.0, False, torch.device("cpu"), time.perf_counter(),
                         scale_of(cell))
    readings = control.stylize_readings(r)
    assert set(readings) == set(sound)
    # the control has to fail one of the cell's compared numbers
    assert any(readings[k] >= 3 * sound[k] for k in r.workload["limits"]), (readings, sound)


def test_the_training_faults_read_above_the_program():
    cell = "fedavg-r50-222-b32"
    seed = 2**31 + 31
    sound = numbers(run_cell(cell, seed=seed))
    r = harness.load_run(cell, seed, 0.0, False, torch.device("cpu"), time.perf_counter(),
                         scale_of(cell))
    readings = control.train_readings(r)
    assert readings["half_batch.loss_gap"] > 3 * sound["loss_gap"]
    assert readings["exchange_left_out.aggregate_gap"] > 10 * sound["aggregate_gap"]
    assert readings["state_unchanged.grad_gap"] == 1.0
