"""The port's ``run_chain`` (``ccst_tpu_torch/experiments/semantic_validation.py``)
against the JAX project's, on the CPU at a tiny size (32 px, 4 images a
class): the JAX-made LSUV encoder and a JAX decoder carried over into both,
for the ``ref`` (float32) and ``int8-static`` Overall arms and the Single arm.

- the banks (bfloat16 features, float32 statistics): each package's held to
  the float32 bank of the same images, the port within twice ``ccst_tpu``'s
  own distance from it (max and mean over the channels) and within 1e-2 of its
  largest value: a sum near a bf16 rounding boundary rounds apart in the two
  packages and the step carries on through the layers below, so rtol 1e-4
  holds only for float32 banks (``tests/test_torch_cli.py``);
- the fusion lists byte for byte;
- every stylized PNG within one uint8 level (``tests/test_torch_cli_single.py``'s
  bar), on a decoder whose outputs spread over [0, 1] without saturating.
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccst_tpu.data.loader import load_image
from ccst_tpu.models import vgg as jvgg
from experiments import semantic_validation as jsv
from tests.test_torch_experiments import (  # noqa: F401  (module fixtures)
    SEED,
    SIZE,
    _files,
    _probes,
    jax_encoder,
    roots,
    shapes4_registered,
)
from tests.torch_parity import one_torch_thread, pinned_io_tier  # noqa: F401
from ccst_tpu_torch.experiments import semantic_validation as tsv


# 4 images a class (3 to train): the banks' statistics over fewer relu4_1
# values part further in bf16 than the bar below allows
N_PER_CLASS = 4


def _dataset(root, module):
    module.make_shapes_dataset(root, SIZE, N_PER_CLASS, seed=SEED)
    return root


@pytest.fixture(scope="module")
def decoder(roots, jax_encoder):
    """A JAX decoder whose outputs spread over [0, 1] without saturating: the
    random init with its last conv scaled to outputs of std 0.2 around 0.5 on
    the probe images."""
    dec = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(43), jvgg.DECODER_ARCH))
    feat = jvgg.apply_encoder(jax.tree.map(jnp.asarray, jax_encoder),
                              jnp.asarray(_probes(roots["jax"])))
    out = np.asarray(jvgg.apply_decoder(jax.tree.map(jnp.asarray, dec), feat))
    gain = 0.2 / out.std()
    last = dec["dconv1_1"]
    last["w"], last["b"] = last["w"] * gain, (last["b"] - out.mean()) * gain + 0.5
    return dec


@pytest.mark.parametrize("engine,mode", [("ref", "overall"), ("int8-static", "overall"),
                                         ("ref", "single")])
def test_run_chain_matches_jax(tmp_path, jax_encoder, decoder, engine, mode):
    trees = {t: _dataset(str(tmp_path / t), m) for t, m in (("jax", jsv), ("torch", tsv))}
    jsv.run_chain(trees["jax"], SIZE, engine, SEED, jax.tree.map(jnp.asarray, jax_encoder),
                  jax.tree.map(jnp.asarray, decoder), mode=mode)
    tsv.run_chain(trees["torch"], SIZE, engine, SEED, jax_encoder, decoder, mode=mode,
                  device="cpu")

    if mode == "overall":
        # held to the float32 bank of the same images (module docstring)
        from ccst_tpu_torch.config import StylizeConfig
        from ccst_tpu_torch.pipeline.style_bank import compute_style_bank, load_style_stats

        exact = str(tmp_path / "float32_banks")
        for d in jsv.DOMAINS:
            cfg = StylizeConfig(dataset="shapes4", list_root=trees["torch"],
                                data_root=trees["torch"], style_stats_dir=exact, image_size=SIZE,
                                batch_size=8, dtype="float32")
            want = compute_style_bank(cfg, d, encoder_params=jax_encoder, device="cpu")
            ours, theirs = (load_style_stats(os.path.join(
                trees[t], "style_stats", "shapes4", f"{d}_mean_std.npz")) for t in ("torch", "jax"))
            for a, b, w in zip(ours, theirs, want):
                scale = np.abs(w).max()
                np.testing.assert_allclose(a, w, rtol=0, atol=1e-2 * scale, err_msg=d)
                assert np.abs(a - w).max() <= 2 * np.abs(b - w).max() + 1e-6 * scale, d
                assert np.abs(a - w).mean() <= 2 * np.abs(b - w).mean() + 1e-6 * scale, d
    fusion = os.path.join("txt_lists", f"shapes4_adain-{mode}-K3", "mixed")
    lists = sorted(os.listdir(os.path.join(trees["jax"], fusion)))
    assert lists == [f"{d}_train.txt" for d in jsv.DOMAINS[:-1]]
    for f in lists:
        assert filecmp.cmp(os.path.join(trees["jax"], fusion, f),
                           os.path.join(trees["torch"], fusion, f), shallow=False), f

    out = os.path.join("SHAPES4", f"all_style_transferred_{mode.capitalize()}")
    pngs = _files(os.path.join(trees["jax"], out))
    assert pngs == _files(os.path.join(trees["torch"], out))
    train = 4 * (N_PER_CLASS - max(N_PER_CLASS // 4, 1))  # a domain's train images
    assert len(pngs) == 3 * 3 * train  # contents x styles x train images
    spread = 0
    for f in pngs:
        a, b = (load_image(os.path.join(trees[t], out, f), dtype="uint8").astype(int)
                for t in ("jax", "torch"))
        assert np.abs(a - b).max() <= 1, f
        spread = max(spread, a.max() - a.min())
    assert spread >= 64  # outputs spread, so one level is a bar that says something
