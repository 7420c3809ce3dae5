"""The ccst-tpu-torch CLI on the CPU: style-bank -> stylize --mode overall, and
calibrate -> stylize --engine int8-fused, on a synthetic PACS tree with one
shared .npz weight file, held against ccst_tpu's style banks, calibration and
stylize CLI on the same files.

Tolerances: banks rtol=1e-4, atol=1e-6 (float32 encoder, sums in another
order); calibration scales rtol=1e-5 (a float32 pass, sums in another order);
stylized PNGs within one uint8 level.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from ccst_tpu.config import StylizeConfig
from ccst_tpu.data.lists import write_list
from ccst_tpu.data.loader import load_image, save_image_u8
from ccst_tpu.models import convert as jconvert
from ccst_tpu.models import vgg as jvgg
from ccst_tpu_torch.cli import main as torch_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]


def _common(root, stats_dir, out_root):
    return [
        "--dataset", "pacs", "--list-root", root, "--data-root", root,
        "--output-root", out_root, "--style-stats-dir", stats_dir,
        "--image-size", "32", "--batch-size", "2", "--dtype", "float32",
        "--vgg-weights", os.path.join(root, "enc.npz"),
        "--decoder-weights", os.path.join(root, "dec.npz"),
    ]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 domains x 3 images (the last batch of 2 is padded), weights from
    PRNGKey(42/43) in one .npz each, then the port's style-bank + stylize."""
    root = str(tmp_path_factory.mktemp("pacs"))
    rng = np.random.default_rng(0)
    for d in DOMAINS:
        names = []
        for i in range(3):
            rel = f"PACS/kfold/{d}/dog/img{i}.png"
            img = np.clip(rng.normal(0.3 + 0.1 * i, 0.1, (36, 36, 3)), 0, 1)
            save_image_u8(img.astype(np.float32), os.path.join(root, rel))
            names.append(rel)
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt"), names, [0] * 3)
    jconvert.save_npz(os.path.join(root, "enc.npz"),
                      jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH))
    jconvert.save_npz(os.path.join(root, "dec.npz"),
                      jvgg.init_params(jax.random.PRNGKey(43), jvgg.DECODER_ARCH))
    stats = os.path.join(root, "stats_torch")
    out = os.path.join(root, "out_torch")
    common = _common(root, stats, out) + ["--device", "cpu"]
    assert torch_cli(["style-bank", *common]) == 0
    assert torch_cli(["stylize", *common, "--target", "photo", "--mode", "overall"]) == 0
    return root


def _outputs(out_root):
    base = os.path.join(out_root, "PACS", "all_style_transferred_Overall", "photo")
    return sorted(
        os.path.relpath(os.path.join(dp, f), base) for dp, _, fs in os.walk(base) for f in fs
    )


def test_cli_writes_outputs_and_timing(tree):
    out = os.path.join(tree, "out_torch")
    files = _outputs(out)
    assert len(files) == 3 * 3 and os.path.join("cartoon", "dog", "img0_cartoon.png") in files
    with open(os.path.join(out, "pacs_photo_overall_stylize_time.json")) as f:
        timing = json.load(f)
    assert timing["images_per_style"] == 3 and timing["styles"] == [
        "art_painting", "cartoon", "sketch"
    ]
    for d in DOMAINS:
        ref = np.load(os.path.join(tree, "stats_torch", "pacs", f"{d}_mean_std.npy"))
        assert ref.shape == (2, 1, 512, 1, 1) and np.isfinite(ref).all()


def test_banks_match_jax_compute_style_bank(tree):
    from ccst_tpu.pipeline.style_bank import compute_style_bank, load_style_stats

    jax_stats = os.path.join(tree, "stats_jax")
    cfg = StylizeConfig(
        dataset="pacs", list_root=tree, data_root=tree, style_stats_dir=jax_stats,
        image_size=32, batch_size=2, dtype="float32",
    )
    enc = jconvert.load_npz(os.path.join(tree, "enc.npz"))
    for d in DOMAINS:
        compute_style_bank(cfg, d, encoder_params=enc)
        for ext in ("npz", "npy"):
            ours = load_style_stats(os.path.join(tree, "stats_torch", "pacs", f"{d}_mean_std.{ext}"))
            theirs = load_style_stats(os.path.join(jax_stats, "pacs", f"{d}_mean_std.{ext}"))
            for a, b in zip(ours, theirs):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_pngs_match_jax_stylize_cli(tree):
    """The JAX CLI stylizes from the port's banks; every PNG within 1 level."""
    from ccst_tpu.cli import main as jax_cli

    jax_out = os.path.join(tree, "out_jax")
    common = _common(tree, os.path.join(tree, "stats_torch"), jax_out)
    assert jax_cli(["stylize", *common, "--target", "photo", "--mode", "overall"]) == 0
    files = _outputs(jax_out)
    assert files == _outputs(os.path.join(tree, "out_torch"))
    base = ("PACS", "all_style_transferred_Overall", "photo")
    for rel in files:
        ours = load_image(os.path.join(tree, "out_torch", *base, rel), dtype="uint8")
        theirs = load_image(os.path.join(jax_out, *base, rel), dtype="uint8")
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1, rel


def test_calibrate_then_int8_fused_stylize(tree, capsys):
    """calibrate writes the scales file next to the banks; stylize picks it up
    by default; ccst_tpu's calibrate on the same tree gives the same scales."""
    from ccst_tpu.cli import main as jax_cli
    from ccst_tpu.models.vgg_fast import load_scales as jax_load_scales
    from ccst_tpu_torch.models import convert as tconvert
    from ccst_tpu_torch.models import vgg_fast as tvf

    stats = os.path.join(tree, "stats_int8")
    shutil.copytree(os.path.join(tree, "stats_torch"), stats)
    out = os.path.join(tree, "out_int8")
    common = _common(tree, stats, out) + ["--device", "cpu", "--target", "photo"]
    assert torch_cli(["calibrate", *common, "--engine", "int8-fused", "--max-images", "2"]) == 0
    path = os.path.join(stats, "pacs", "photo_q8_scales.json")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "scales_path": path, "n_scales": 18,
    }
    fp = tvf.weights_fingerprint(tconvert.load_npz(os.path.join(tree, "enc.npz")),
                                 tconvert.load_npz(os.path.join(tree, "dec.npz")))
    ours = tvf.load_scales(path, expect_fingerprint=fp)
    jax_path = os.path.join(tree, "jax_scales.json")
    assert jax_cli(["calibrate", *_common(tree, stats, out), "--target", "photo",
                    "--engine", "int8-fused", "--max-images", "2", "--scales", jax_path]) == 0
    theirs = jax_load_scales(jax_path, expect_fingerprint=fp)
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, err_msg=k)

    assert torch_cli(["stylize", *common, "--mode", "overall", "--engine", "int8-fused"]) == 0
    assert f"loading int8 calibration from {path}" in capsys.readouterr().out
    files = _outputs(out)
    assert files == _outputs(os.path.join(tree, "out_torch"))
    base = (out, "PACS", "all_style_transferred_Overall", "photo")
    img = load_image(os.path.join(*base, files[0]), dtype="uint8")
    assert img.shape == (32, 32, 3) and int(img.max()) > int(img.min())


def test_cli_never_loads_jax(tree):
    common = [*_common(tree, os.path.join(tree, "stats_sub"), tree), "--device", "cpu"]
    code = (
        "import sys, json\n"
        "from ccst_tpu_torch.cli import main\n"
        "from ccst_tpu_torch.benchmarks import fused_pool_conv_ab, int8_mm, winograd_ab\n"
        f"rc = main({['style-bank', *common]!r})\n"
        f"rc += main({['calibrate', *common, '--target', 'photo', '--engine', 'int8-static']!r})\n"
        "print(json.dumps({'rc': rc, 'jax': 'jax' in sys.modules,\n"
        "                  'ccst_tpu': 'ccst_tpu' in sys.modules}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "rc": 0, "jax": False, "ccst_tpu": False}
    assert os.path.exists(os.path.join(tree, "stats_sub", "pacs", "cartoon_mean_std.npz"))
    assert os.path.exists(os.path.join(tree, "stats_sub", "pacs", "photo_q8_scales.json"))
