"""The output check sees each fault a cell can have: a run at test size on the
CPU, with the program broken underneath, comes out not correct.

At the test size the chip's limits do not apply, so each test first runs the
sound program on the same seed and holds the faulty run to four times the
sound readings (at least a floor per number): a fault must read above that.
"""
import numpy as np
import pytest
import torch

from gpubench.tests.tiny import run_cell

FLOOR = {"image_mae_worst": 1.0, "far_share_worst": 0.01, "loss_gap": 1e-4, "grad_gap": 1e-3,
         "update_gap_median": 1e-3, "aggregate_gap": 1e-5, "eval_loss_gap": 1e-4}


def limits_from_sound_run(cell):
    sound = run_cell(cell)
    return {c.name: max(4 * c.value, FLOOR[c.name]) for c in sound.checks}


def assert_caught(cell, monkeypatch_faults, **kw):
    limits = limits_from_sound_run(cell)
    monkeypatch_faults()
    r = run_cell(cell, limits=limits, **kw)
    assert not all(c.ok for c in r.checks), [(c.name, c.value, c.limit) for c in r.checks]


# ---------------------------------------------------------------------------
# stylize
# ---------------------------------------------------------------------------

STYLIZE = ["stylize-ref-512-b32", "stylize-int8fused-512-b32", "stylize-single-ref-512-b32"]


def _engine():
    from ccst_tpu_torch.pipeline import stylize

    return stylize.StylizeEngine


@pytest.mark.parametrize("cell", STYLIZE)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    engine = _engine()
    multi, single = engine.stylize_multi, engine.stylize

    def half(fn, axis):
        def call(self, images, *a, **kw):
            out = fn(self, images[: images.shape[0] // 2], *a, **kw)
            return torch.cat([out, out], dim=axis)
        return call

    def plant():
        monkeypatch.setattr(engine, "stylize_multi", half(multi, 1))
        monkeypatch.setattr(engine, "stylize", half(single, 0))

    assert_caught(cell, plant)


@pytest.mark.parametrize("cell", STYLIZE)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    engine = _engine()
    finish = engine._finish

    def altered(self, out):
        y = finish(self, out).clone()
        y[0] = 255 - y[0]
        return y

    assert_caught(cell, lambda: monkeypatch.setattr(engine, "_finish", altered))


@pytest.mark.parametrize("cell", STYLIZE)
def test_a_stale_output_returned(cell, monkeypatch):
    """The analog of a step that returns its state unchanged: every call
    hands back the first call's output."""
    engine = _engine()
    multi, single = engine.stylize_multi, engine.stylize
    first = {}

    def stale(fn):
        def call(self, *a, **kw):
            out = fn(self, *a, **kw)
            return first.setdefault(fn.__name__, out)
        return call

    def plant():
        monkeypatch.setattr(engine, "stylize_multi", stale(multi))
        monkeypatch.setattr(engine, "stylize", stale(single))

    assert_caught(cell, plant)


def test_calibration_scales_altered(monkeypatch):
    """Each conv calibrated with the next conv's scale: the set-up's answer
    altered where it is produced, seen through the outputs."""
    from ccst_tpu_torch.models import vgg_fast

    calibrate = vgg_fast.calibrate_scales

    def altered(*a, **kw):
        scales = calibrate(*a, **kw)
        names = list(scales)
        return {k: scales[names[(i + 1) % len(names)]] for i, k in enumerate(names)}

    assert_caught("stylize-int8fused-512-b32",
                  lambda: monkeypatch.setattr(vgg_fast, "calibrate_scales", altered))


def test_style_statistics_altered(monkeypatch):
    engine = _engine()
    stats_of = engine.style_stats_of

    def altered(self, image):
        mean, std = stats_of(self, image)
        return mean * 1.25, std

    assert_caught("stylize-single-ref-512-b32",
                  lambda: monkeypatch.setattr(engine, "style_stats_of", altered))


# ---------------------------------------------------------------------------
# federated training
# ---------------------------------------------------------------------------

FEDAVG = "fedavg-r50-222-b32"


def _patch_step(monkeypatch, change):
    from ccst_tpu_torch.federated import runtime, train_ops

    make = runtime.make_train_step

    def make_faulty(*a, **kw):
        step = make(*a, **kw)
        return train_ops.TrainStep(step.draw, change(step.apply))

    monkeypatch.setattr(runtime, "make_train_step", make_faulty)


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    def change(apply):
        def faulty(state, server, batch, draws, idx):
            return state, apply(state, server, batch, draws, idx)[1]
        return faulty

    assert_caught(FEDAVG, lambda: _patch_step(monkeypatch, change))


def test_half_of_each_batch_left_out_the_mean_over_the_rest(monkeypatch):
    def change(apply):
        def faulty(state, server, batch, draws, idx):
            n = batch["images"].shape[0] // 2
            half = {k: (v[:n] if k in ("images", "labels", "mask") else v)
                    for k, v in batch.items()}
            boxes, flips = draws["crop"]
            return apply(state, server, half, {**draws, "crop": (boxes[:n], flips[:n])}, idx)
        return faulty

    assert_caught(FEDAVG, lambda: _patch_step(monkeypatch, change))


def test_the_loss_altered_where_it_is_produced(monkeypatch):
    def change(apply):
        def faulty(state, server, batch, draws, idx):
            new, m = apply(state, server, batch, draws, idx)
            return new, m._replace(loss=m.loss * 1.5)
        return faulty

    assert_caught(FEDAVG, lambda: _patch_step(monkeypatch, change))


def test_the_exchange_between_clients_left_out(monkeypatch):
    from ccst_tpu_torch.federated import runtime

    def no_exchange(mode, states, weights):
        own = {k: v.clone() for k, v in states[0].items()}
        return own, [{k: v.clone() for k, v in own.items()} for _ in states]

    assert_caught(FEDAVG, lambda: monkeypatch.setattr(runtime, "aggregate", no_exchange))


def test_the_evaluation_answers_altered(monkeypatch):
    from ccst_tpu_torch.federated import runtime

    make = runtime.make_eval_step

    def make_faulty(*a, **kw):
        step = make(*a, **kw)

        def faulty(state, batch):
            loss, correct, count = step(state, batch)
            return loss * 1.5, count - correct, count
        return faulty

    assert_caught(FEDAVG, lambda: monkeypatch.setattr(runtime, "make_eval_step", make_faulty))


def test_the_sound_program_is_correct_within_the_test_limits():
    for cell in STYLIZE + [FEDAVG]:
        limits = limits_from_sound_run(cell)
        r = run_cell(cell, limits=limits)
        assert all(c.ok for c in r.checks), cell
        assert np.isfinite([c.value for c in r.checks]).all()
