"""``tests/semantic_draws.py``, the program that runs the shapes4 validation
over initial draws on both packages: its tint probe, the JAX draws it hands
the card, and its summary over runs (the runs themselves take minutes to
hours and are not collected)."""
from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest

from tests import semantic_draws as sd
from tests.privacy_draws import jax_draws


def _png_tree(tmp_path, tints):
    """One 8 x 8 PNG a (tint, label): a grey square under the tint."""
    from PIL import Image

    paths, labels = [], []
    for i, (tint, label) in enumerate(tints):
        img = (np.full((8, 8, 3), 0.6) * np.asarray(tint) * 255).astype(np.uint8)
        path = str(tmp_path / f"img{i:03d}.png")
        Image.fromarray(img).save(path)
        paths.append(path)
        labels.append(label)
    return paths, labels


def test_tint_probe_reads_a_class_tint_and_not_a_random_one(tmp_path):
    rng = np.random.default_rng(0)
    for name in ("tied", "random"):
        (tmp_path / name).mkdir()
    hues = np.eye(3) * 0.8 + 0.2  # one tint a class
    tied = [(hues[c], c) for c in range(3) for _ in range(6)]
    assert sd.tint_probe(*_png_tree(tmp_path / "tied", tied)) == 1.0
    shuffled = [(rng.uniform(0.2, 1.0, 3), c) for c in range(4) for _ in range(20)]
    assert sd.tint_probe(*_png_tree(tmp_path / "random", shuffled)) < 0.5


def test_saved_jax_draws_load_as_the_draws(tmp_path):
    sd.save_draws(str(tmp_path), [1])
    for want, got in zip(jax_draws(1), sd.load_draws(str(tmp_path / "k1.npz"))):
        assert set(got) == set(want)
        jax.tree.map(np.testing.assert_array_equal, got, want)


def _grid_row(side, k, device, accs):
    per_seed = [{"seed": s + 1, "bf16": b, "single": g, "decoder": {"loss_c": 0.1, "loss_s": 0.2},
                 "probe": {p: {"pooled": 0.3 + 0.1 * (b - g) + 0.01 * k, "client_mean": 0.4}
                           for p in ("source", "overall", "single")}}
                for s, (b, g) in enumerate(accs)]
    gaps = [b - g for b, g in accs]
    return {"side": side, "k": k, "quick": False, "device": device, "threads": 1,
            "depth": "grid", "seeds": [s["seed"] for s in per_seed], "per_seed": per_seed,
            "mean": {"bf16": float(np.mean([b for b, _ in accs])),
                     "single": float(np.mean([g for _, g in accs]))},
            "gap_mean": float(np.mean(gaps)), "n_bf16_above_single": sum(g > 0 for g in gaps),
            "ae": {"step": 1500, "recon": 0.02, "inv": 0.0002, "tintreg": 0.04}}


def test_summary_counts_the_pairs_and_tests_each_side_against_each_other(tmp_path):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    rows = ([_grid_row("jax", k, "cpu", [(0.9, 0.8), (0.7, 0.8)]) for k in range(3)]
            + [_grid_row("port", k, card, [(0.6, 0.8), (0.7, 0.8)]) for k in range(4)]
            + [{"side": "port", "k": 7, "gap": 1.5, "per_image": 15.0, "overall": 13.5,
                "mean_image": 14.4, "seconds": 1.0},
               {"k": 0, "steps": 2, "float64": {"ae": [
                   {"step": 1, "port64_vs_jax64": 1e-8, "port32_vs_port64": 1e-3},
                   {"step": 2, "port64_vs_jax64": 3e-8, "port32_vs_port64": 0.2}]}},
               {"draws": 30, "statistics": 117, "smallest_p": {"enc.conv1_1.w.std": 0.3}}])
    lines = tmp_path / "rows.jsonl"
    lines.write_text("[stage output]\n" + "\n".join(json.dumps(r) for r in rows) + "\n")
    out = str(tmp_path / "summary.json")
    summary = sd.summarize([str(lines)], out)
    across = summary["grid full every device"]
    assert across["jax"]["pairs_bf16_above_single"] == [3, 6]
    assert across[f"port {card}"]["pairs_bf16_above_single"] == [0, 8]
    gap = across["jax"]["gap_mean"]
    assert gap["median"] == pytest.approx(0.0)
    assert 0.0 < gap["mann_whitney"][f"port {card}"]["p"] < 0.05
    assert summary[f"grid full {card}"]["port"]["n"] == 4
    assert across["jax"]["spearman_overall_probe_vs_gap"]["rho"] > 0.5  # the rows' probe follows
    assert summary["stylizer full cpu"]["jax"]["decoder.loss_c"]["median"] == pytest.approx(0.1)
    assert summary["privacy quick cpu"]["port"]["below_2_db"] == [1, 1]
    assert summary["float64"] == [{"k": 0, "steps": 2, "ae": {
        "port64_vs_jax64": {"max": 3e-8, "first_step_above_1e-2": None},
        "port32_vs_port64": {"max": 0.2, "first_step_above_1e-2": 2}}}]
    assert summary["draw_stats"]["statistics"] == 117
    with open(out) as f:
        written = json.load(f)
    assert len(written["records"]) == 10  # every record read, and nothing else
    assert sd.summarize([out]) == summary  # the written file summarizes as its sources do


@pytest.mark.parametrize("side", ["port-from-jax", "mix-port-enc", "mix-jax-enc"])
def test_sides_start_from_the_draws_they_name(side):
    from ccst_tpu_torch.experiments.semantic_validation import initial_weights

    own, theirs = initial_weights(2000), jax_draws(2)
    want = {"port-from-jax": theirs, "mix-port-enc": (own[0],) + theirs[1:],
            "mix-jax-enc": (theirs[0],) + own[1:]}[side]
    got = sd._Side(side, 2, "cpu").init
    assert len(got) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        jax.tree.map(lambda x, y: np.testing.assert_array_equal(np.asarray(x), np.asarray(y)), g, w)


def test_the_card_side_imports_no_jax():
    """The port's side runs on the card, where the JAX package must not run:
    building it imports neither ``jax`` nor ``tests.privacy_draws``."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.argv = ['x']; import tests.semantic_draws as sd; "
            "sd._Side('port', 0, 'cpu'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ccst_tpu', 'experiments')"
            " or m == 'tests.privacy_draws']; print(bad); sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert done.returncode == 0, done.stdout + done.stderr
