"""The WCT cell's output check at test size on the CPU: every control and each
fault it can have come out not correct; and its counts from shapes.

The check holds each stage of every level (encoder, whitening, apply,
decoder) to the reference given the stage's own recorded input. These tests
hold the program in float32 (``precision`` float32, the engine's verification
mode), where a sound run's stages read 1e-6 or less. As in
``test_gpubench_faults.py``, each faulty run is held to four times the sound
run's readings on the same seed (at least a floor per number). The limits the
chip runs use, at full size in bfloat16, come from ``python -m
gpubench.drivers.wct`` (``PERF.md``).
"""
import time
from unittest import mock

import pytest
import torch

from ccst_tpu_torch import native
from gpubench import harness
from gpubench.tests.tiny import STYLIZE

CELL = "stylize-wct-512-b32"
SEED = 2**31 + 11
SCALE = {**STYLIZE, "precision": "float32"}
FLOOR = {"encode_gap": 1e-4, "whiten_gap": 1e-4, "apply_gap": 1e-4, "decode_gap": 1e-4}


def run(limits=None):
    torch.set_num_threads(2)
    r = harness.load_run(CELL, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                         SCALE)
    if limits is not None:
        r.workload = {**r.workload, "limits": limits}
    with mock.patch.object(native, "available", lambda: False):
        harness.execute(r)
    return r


def numbers(r):
    return {**r.readings, **{c.name: c.value for c in r.checks}}


@pytest.fixture(scope="module")
def limits():
    found = numbers(run())
    return {k: max(4 * found[k], f) for k, f in FLOOR.items()}


def test_the_sound_program_is_correct_within_the_test_limits(limits):
    r = run(limits)
    assert all(c.ok for c in r.checks)
    assert set(numbers(r)) == {"image_mae_worst", "far_share_worst", "bank_gap", "encode_gap",
                               "whiten_gap", "apply_gap", "decode_gap"}


def test_both_controls_come_out_not_correct(limits):
    from gpubench.drivers import wct

    r = harness.load_run(CELL, SEED, 0.0, False, torch.device("cpu"), time.perf_counter(),
                         SCALE)
    readings = wct.control_readings(r)
    for control in wct.CONTROLS:
        assert any(readings[f"{control}.{k}"] > v for k, v in limits.items()), (control,
                                                                              readings)
    # each on its own stage: int8 convs on the encoder and the decoder, a
    # bfloat16 Gram and solve on the whitening, a float8 apply on the apply
    assert readings["int8.encode_gap"] > limits["encode_gap"]
    assert readings["int8.decode_gap"] > limits["decode_gap"]
    assert readings["bfloat16.whiten_gap"] > limits["whiten_gap"]
    assert readings["float8.apply_gap"] > limits["apply_gap"]


def _caught(limits):
    r = run(limits)
    assert not all(c.ok for c in r.checks), [(c.name, c.value, c.limit) for c in r.checks]


def test_the_whitening_left_out(limits, monkeypatch):
    """A diagonal, AdaIN-like transform: each channel scaled by its own
    variance, the correlations between channels kept."""
    from ccst_tpu_torch.ops import wct as ops

    def diagonal(a, iters=ops.NS_ITERS):
        return torch.diag_embed(torch.diagonal(a, dim1=1, dim2=2).rsqrt())

    monkeypatch.setattr(ops, "inv_sqrt", diagonal)
    _caught(limits)


def test_one_level_skipped(limits, monkeypatch):
    from ccst_tpu_torch.models import vgg

    monkeypatch.setattr(vgg, "WCT_LEVELS", tuple(lv for lv in vgg.WCT_LEVELS if lv != "relu3_1"))
    _caught(limits)


def test_a_stale_bank(limits, monkeypatch):
    """Every domain handed the first bank the set-up made, as a bank file left
    from another run would be."""
    from ccst_tpu_torch.pipeline import style_bank

    finalize = style_bank.wct_bank_finalize
    first = []

    def stale(sums):
        bank = finalize(sums)
        first.append(bank)
        return first[0]

    monkeypatch.setattr(style_bank, "wct_bank_finalize", stale)
    _caught(limits)


def test_the_counts_of_a_call_at_512_px():
    """189.4 GFLOP an image to relu5_1, 621.8 a content-style pair after it,
    65.75 TFLOP of convs and 1.72 of Gram and apply a call of 32 under 3
    banks, and its 416 solves (the 3x3 convs counted as ``flops/vgg.py``
    counts them)."""
    from gpubench.flops import vgg as vgg_flops
    from gpubench.flops import wct as wct_flops

    job = wct_flops.Job(512, 32, 3)
    assert vgg_flops.pass_flops(wct_flops.encoder_to("relu5_1"), 512) == pytest.approx(189.35e9,
                                                                                      rel=1e-3)
    assert wct_flops.decoder_from("relu4_1") == vgg_flops.DECODER
    assert wct_flops.pair_conv_flops(512) == pytest.approx(621.80e9, rel=1e-3)
    assert wct_flops.conv_flops(job) == pytest.approx(65.75e12, rel=1e-3)
    assert wct_flops.transform_flops(job) == pytest.approx(1.718e12, rel=1e-3)
    assert job.solves == 416 and job.images == 96
    # the centring kernel: per position 2 C in, 2 (C + 8) + 2 C out, 13 launches a call
    assert wct_flops.centre_split_bytes(job) == pytest.approx(18.756e9, rel=1e-3)
    # K3's bound a call (k3_roofline.wct): 13 + 49 S bfloat16 launches
    assert wct_flops.k3_bound_s(job) == pytest.approx(75.403e-3, rel=1e-3)
