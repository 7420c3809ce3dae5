"""``ccst-tpu-torch stylize`` beyond the Overall batch-major path, on the CPU:
``--mode single`` (one seeded style image drawn per content batch, the
``_discardBlackWhite`` list preferred where it exists), ``--skip-existing``,
``--output-size`` and the ``packed`` and dynamic ``int8`` engines, held
against ``ccst-tpu stylize`` on the same synthetic PACS tree and weights.

Tolerances: float32 PNGs of the two CLIs within one uint8 level (the same
maths, sums in another order); the packed engine's PNGs within one level of
the port's ``ref`` PNGs (float32: exact to float tolerance); the int8 engine's
within 2% of the output range in mean (PSNR well above ccst_tpu's 20 dB bar).
The random weights are scaled so that outputs spread over [0, 1] and the
style image drawn moves them by tens of levels.
"""
import os

import jax
import numpy as np
import pytest

from ccst_tpu.cli import main as jax_cli
from ccst_tpu.data.lists import write_list
from ccst_tpu.data.loader import load_image, save_image_u8
from ccst_tpu.models import convert as jconvert
from ccst_tpu.models import vgg as jvgg
from ccst_tpu_torch.cli import main as torch_cli
from tests.torch_parity import pinned_io_tier  # noqa: F401  (both CLIs read the same pixels)

DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]
N_IMAGES = 5  # per domain: batches of 2, 2 and 1 (padded)


def _common(root, out_root, stats="stats"):
    return [
        "--dataset", "pacs", "--list-root", root, "--data-root", root,
        "--output-root", out_root, "--style-stats-dir", os.path.join(root, stats),
        "--image-size", "32", "--batch-size", "2", "--dtype", "float32",
        "--vgg-weights", os.path.join(root, "enc.npz"),
        "--decoder-weights", os.path.join(root, "dec.npz"), "--target", "photo",
    ]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 domains x 5 images, weights from PRNGKey(42/43) scaled as below,
    the port's style banks."""
    root = str(tmp_path_factory.mktemp("pacs"))
    rng = np.random.default_rng(0)
    for d in DOMAINS:
        names = []
        for i in range(N_IMAGES):
            rel = f"PACS/kfold/{d}/dog/img{i}.png"
            img = np.clip(rng.normal(0.2 + 0.12 * i, 0.2, (36, 36, 3)), 0, 1)
            save_image_u8(img.astype(np.float32), os.path.join(root, rel))
            names.append(rel)
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt"), names, [0] * N_IMAGES)
    # He gain (x sqrt 6 on the init's bound) on every 3x3 conv, so that the
    # style image's statistics reach the output; +0.5 on the last bias
    gain = lambda params: {k: {"w": v["w"] * (6 ** 0.5 if k != "conv0" else 1), "b": v["b"]}
                           for k, v in params.items()}
    dec = gain(jvgg.init_params(jax.random.PRNGKey(43), jvgg.DECODER_ARCH))
    dec["dconv1_1"]["b"] = dec["dconv1_1"]["b"] + 0.5
    jconvert.save_npz(os.path.join(root, "enc.npz"),
                      gain(jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH)))
    jconvert.save_npz(os.path.join(root, "dec.npz"), dec)
    common = _common(root, root)
    assert torch_cli(["style-bank", *common, "--device", "cpu"]) == 0
    return root


def _outputs(out_root, mode="Overall"):
    base = os.path.join(out_root, "PACS", f"all_style_transferred_{mode}", "photo")
    return {os.path.relpath(os.path.join(dp, f), base): os.path.join(dp, f)
            for dp, _, fs in os.walk(base) for f in fs}


def _max_level_diff(a, b):
    return max(np.abs(load_image(a[k], dtype="uint8").astype(int)
                      - load_image(b[k], dtype="uint8").astype(int)).max() for k in a)


@pytest.mark.parametrize("filtered", [False, True], ids=["train-list", "discardBlackWhite"])
def test_single_mode_matches_jax_cli(tree, tmp_path, filtered):
    """The same output files and, batch by batch, the same style image drawn:
    every PNG within one level of ccst-tpu's. With a ``_discardBlackWhite``
    list of one image per style domain, every batch takes that image, so
    the outputs differ from those drawn from the whole train list."""
    root = str(tmp_path / "tree")
    os.makedirs(root)
    for name in ("PACS", "txt_lists", "enc.npz", "dec.npz", "stats"):
        os.symlink(os.path.join(tree, name), os.path.join(root, name))
    if filtered:
        for d in DOMAINS:
            # the path the single-mode lookup reads (train_list_path lower-cases it)
            write_list(os.path.join(root, "txt_filtered", "txt_lists", "pacs_discardblackwhite",
                                    f"{d}_train.txt"), [f"PACS/kfold/{d}/dog/img3.png"], [0])
        os.symlink(os.path.join(tree, "txt_lists", "pacs"),
                   os.path.join(root, "txt_filtered", "txt_lists", "pacs"))
    list_root = os.path.join(root, "txt_filtered") if filtered else root
    outs = {}
    for tag, cli, extra in (("torch", torch_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        argv = _common(root, os.path.join(root, f"out_{tag}"))
        argv[argv.index("--list-root") + 1] = list_root
        assert cli(["stylize", *argv, "--mode", "single", *extra]) == 0
        outs[tag] = _outputs(os.path.join(root, f"out_{tag}"), "Single")
    assert sorted(outs["torch"]) == sorted(outs["jax"])
    assert len(outs["torch"]) == N_IMAGES * 3
    assert _max_level_diff(outs["torch"], outs["jax"]) <= 1
    if filtered:
        unfiltered = os.path.join(root, "out_unfiltered")
        assert torch_cli(["stylize", *_common(root, unfiltered), "--mode", "single",
                          "--device", "cpu"]) == 0
        assert _max_level_diff(outs["torch"], _outputs(unfiltered, "Single")) > 8


def test_skip_existing_writes_only_what_is_missing(tree, tmp_path, monkeypatch):
    """A rerun with ``--skip-existing`` writes nothing; after k outputs are
    deleted it writes exactly those k, with the bytes they had."""
    from ccst_tpu_torch.pipeline import stylize as mod

    out = str(tmp_path / "out")
    argv = ["stylize", *_common(tree, out), "--mode", "overall", "--device", "cpu"]
    assert torch_cli(argv) == 0
    first = _outputs(out)
    assert len(first) == N_IMAGES * 3
    saved = {k: open(p, "rb").read() for k, p in first.items()}
    written = []
    save = mod.save_image_u8
    monkeypatch.setattr(mod, "save_image_u8",
                        lambda img, path: written.append(path) or save(img, path))
    assert torch_cli(argv + ["--skip-existing"]) == 0
    assert written == []
    gone = sorted(first)[1::4]  # one or two per style, across batches
    for k in gone:
        os.remove(first[k])
    assert torch_cli(argv + ["--skip-existing"]) == 0
    assert sorted(written) == sorted(first[k] for k in gone) and len(gone) == 4
    assert {k: open(p, "rb").read() for k, p in _outputs(out).items()} == saved


def test_output_size_matches_jax_cli(tree, tmp_path):
    outs = {}
    for tag, cli, extra in (("torch", torch_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        out = str(tmp_path / tag)
        assert cli(["stylize", *_common(tree, out), "--mode", "overall",
                    "--output-size", "12", *extra]) == 0
        outs[tag] = _outputs(out)
    assert sorted(outs["torch"]) == sorted(outs["jax"]) and len(outs["torch"]) == N_IMAGES * 3
    assert all(load_image(p, dtype="uint8").shape == (12, 12, 3) for p in outs["torch"].values())
    assert _max_level_diff(outs["torch"], outs["jax"]) <= 1


def test_output_size_matches_jax_cli_on_the_pil_tier(tree, tmp_path, monkeypatch):
    """The pin itself: with ``ccst_tpu``'s native library off (as when its
    build raced another worker's), the port follows it to PIL, and the two
    CLIs' outputs stay within one level."""
    import ccst_tpu.native as jnative
    import ccst_tpu_torch.native as tnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    assert tnative.available() is False
    test_output_size_matches_jax_cli(tree, tmp_path)


@pytest.mark.parametrize("engine", ["packed", "int8"])
def test_fast_engines_through_the_cli(tree, tmp_path, engine):
    """``--engine packed|int8`` writes every output; packed within one level
    of ``ref`` (float32), int8 close to it."""
    outs = {}
    for name in ("ref", engine):
        out = str(tmp_path / name)
        assert torch_cli(["stylize", *_common(tree, out), "--mode", "overall", "--engine", name,
                          "--device", "cpu"]) == 0
        outs[name] = _outputs(out)
    assert sorted(outs[engine]) == sorted(outs["ref"]) and len(outs["ref"]) == N_IMAGES * 3
    ref = np.stack([load_image(outs["ref"][k], dtype="uint8") for k in sorted(outs["ref"])])
    got = np.stack([load_image(outs[engine][k], dtype="uint8") for k in sorted(outs["ref"])])
    assert int(ref.max()) - int(ref.min()) >= 128
    diff = np.abs(got.astype(int) - ref.astype(int))
    if engine == "packed":
        assert diff.max() <= 1
    else:
        assert diff.mean() <= 0.02 * 255, diff.mean()
