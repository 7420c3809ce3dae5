"""The port's privacy inversion (``privacy/invert.py``, the ``invert-train``
and ``invert-eval`` subcommands) against ``ccst_tpu.privacy.invert``, on the
CPU at 32 px with JAX-initialized weights.

Tolerances: ``psnr`` and the float32 ``perceptual_distance`` 1e-5; the bf16
``style_vector`` within 1e-2 relative of each vector's max (bf16's 8 bits, sums
in another order before the one rounding); one inverter step for each
``--loss`` from the same parameters and style vectors: the loss within rtol
1e-5; each gradient leaf within 1e-5 of a float64 gradient's max, or twice
JAX's own float32 distance to it (the perceptual term); after the Adam step
each leaf's median error under 1e-3 lr (a first Adam update is +-lr = 2e-4
wherever the gradient is well above Adam's eps of 1e-8; the inverter's
gradients reach down to that scale, where the first-step update of either
package may differ by up to 2 lr);
``invert-eval`` of a ``ccst-tpu invert-train`` checkpoint through both CLIs,
with the IO tier pinned: PSNR within 1e-3 dB, the perceptual distance and
LPIPS within 1e-5, also with ``--overall``; the port's own checkpoint read back
by ``invert-eval --holdout`` scores the trainer's val split at the PSNR the
trainer recorded.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ccst_tpu.cli import main as jax_cli
from ccst_tpu.data.lists import write_list
from ccst_tpu.data.loader import save_image_u8
from ccst_tpu.models import convert as jconvert
from ccst_tpu.models import vgg as jvgg
from ccst_tpu.privacy import generator as jgen
from ccst_tpu.privacy import invert as jinv
from ccst_tpu_torch.cli import main as torch_cli
from ccst_tpu_torch.models import vgg as tvgg
from ccst_tpu_torch.pipeline.style_bank import save_style_stats
from ccst_tpu_torch.privacy import generator as tgen
from ccst_tpu_torch.privacy import invert as tinv
from tests.test_torch_lpips import _state_dicts
from tests.torch_parity import jit_flax_init, one_torch_thread, pinned_io_tier  # noqa: F401

IMG, BATCH = 32, 2


@pytest.fixture(scope="module")
def enc():
    return jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 1, (3, IMG, IMG, 3)).astype(np.float32)


def test_psnr_and_perceptual_distance_match_jax(enc, images):
    other = np.clip(images + np.random.default_rng(1).normal(0, 0.1, images.shape), 0, 1)
    other = other.astype(np.float32)
    want_p = np.asarray(jinv.psnr(jnp.asarray(images), jnp.asarray(other)))
    got_p = tinv.psnr(torch.from_numpy(images), torch.from_numpy(other)).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-5)
    want_d = np.asarray(jinv.perceptual_distance(jax.tree.map(jnp.asarray, enc),
                                                 jnp.asarray(images), jnp.asarray(other)))
    got_d = tinv.perceptual_distance(tvgg.prepare_params(enc, torch.float32, "cpu"),
                                     torch.from_numpy(images), torch.from_numpy(other)).numpy()
    assert got_d.shape == (3,) and (got_d > 0).all()
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-5)


def test_style_vector_matches_jax(enc, images):
    enc16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), enc)
    want = np.asarray(jinv.style_vector(enc16, jnp.asarray(images).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    got = tinv.style_vector(tvgg.prepare_params(enc, torch.bfloat16, "cpu"),
                            torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (3, 1024) and got.dtype == np.float32
    err = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    assert (err <= 1e-2).all(), err


@pytest.mark.parametrize("loss", ["mse", "mse+perceptual"])
def test_inverter_step_matches_jax(enc, images, loss):
    """One Adam step from the same parameters and style vectors. The
    perceptual term's gradient is ill-conditioned in float32 (features
    divided by their norm at every position): there both packages sit ~1e-3
    of max |g| off a float64 gradient, so the port is held to that reference
    by the rule of chip_smoke.py's training checks (per leaf, its distance at most
    twice JAX's own)."""
    cfg = jinv.InvertConfig(image_size=IMG, loss=loss, lr=2e-4)
    model = jgen.StyleInverter(image_size=IMG)
    params = jax.jit(lambda k: model.init(k, jnp.zeros((1, 1024)))["params"])(
        jax.random.PRNGKey(1))
    enc16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), enc)
    x = jnp.asarray(images)
    z = jinv.style_vector(enc16, x.astype(jnp.bfloat16)).astype(jnp.float32)
    tx = optax.adam(cfg.lr)

    @jax.jit
    def jstep(p, opt_state):
        def loss_fn(p):
            recon = model.apply({"params": p}, z)
            l = jnp.mean(jnp.square(recon - x))
            if loss == "mse+perceptual":
                l = l + cfg.perc_weight * jnp.mean(jinv.perceptual_distance(enc16, recon, x))
            return l

        l, g = jax.value_and_grad(loss_fn)(p)
        upd, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, upd), l, g

    jparams, jloss, jgrads = jstep(params, tx.init(params))
    start = tgen.from_flax(jax.tree.map(np.asarray, params))

    def trainer(dtype, kernel=True):
        tm = tgen.StyleInverter(image_size=IMG)
        tm.load_state_dict(start)
        return tinv.InverterTrainer(tinv.InvertConfig(image_size=IMG, loss=loss, lr=2e-4), enc,
                                    "cpu", dtype=dtype, kernel=kernel, model=tm)

    images_t, z_t = torch.from_numpy(images), torch.from_numpy(np.array(z))
    ref = trainer(torch.float64, kernel=False)
    g64 = torch.autograd.grad(ref.loss(images_t.double(), z_t.double()), ref.opt.params)
    names = [k for k, _ in ref.model.named_parameters()]
    want_g = tgen.from_flax(jax.tree.map(np.asarray, jgrads))
    ours = trainer(torch.float32)
    g32 = torch.autograd.grad(ours.loss(images_t, z_t), ours.opt.params)
    for name, g, gr in zip(names, g32, g64):
        scale = float(gr.abs().max())
        e_ours = float((g.double() - gr).abs().max()) / scale
        e_jax = float((want_g[name].double() - gr).abs().max()) / scale
        assert e_ours <= max(1e-5, 2 * e_jax), (name, e_ours, e_jax)

    got_loss = ours.step(images_t, z_t)
    np.testing.assert_allclose(float(got_loss), float(jloss), rtol=1e-5)
    want = tgen.from_flax(jax.tree.map(np.asarray, jparams))
    for k, v in ours.model.state_dict().items():
        # a first Adam update is -lr g / (|g| + 1e-8): +-lr wherever |g| is well
        # above Adam's eps; a gradient near eps moves its update by up to lr
        err = (v - want[k]).abs()
        assert float(err.median()) <= 1e-3 * cfg.lr and float(err.max()) <= 2 * cfg.lr, k


@pytest.fixture(scope="module")
def tree(tmp_path_factory, enc):
    root = str(tmp_path_factory.mktemp("pacs"))
    rng = np.random.default_rng(0)
    names = []
    for i in range(12):
        rel = f"PACS/kfold/art_painting/dog/img{i}.png"
        save_image_u8(np.clip(rng.normal(0.2 + 0.05 * i, 0.2, (40, 40, 3)), 0, 1)
                      .astype(np.float32), os.path.join(root, rel))
        names.append(rel)
    write_list(os.path.join(root, "txt_lists", "pacs", "art_painting_train.txt"), names, [0] * 12)
    write_list(os.path.join(root, "txt_lists", "pacs", "photo_train.txt"), names[:5], [0] * 5)
    jconvert.save_npz(os.path.join(root, "enc.npz"), enc)
    rng = np.random.default_rng(2)
    save_style_stats(os.path.join(root, "stats", "pacs"), "art_painting",
                     rng.uniform(0, 1, 512), rng.uniform(0.1, 1, 512))
    vgg16, lin = _state_dicts()
    torch.save(vgg16, os.path.join(root, "vgg16.pth"))
    torch.save(lin, os.path.join(root, "lin.pth"))
    return root


def _argv(root, out_dir):
    return ["--dataset", "pacs", "--source", "art_painting", "--list-root", root,
            "--data-root", root, "--out-dir", out_dir, "--image-size", str(IMG),
            "--batch-size", str(BATCH), "--vgg-weights", os.path.join(root, "enc.npz")]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_invert_eval_of_a_jax_checkpoint_matches_jax_cli(tree, tmp_path, capsys, monkeypatch):
    jit_flax_init(monkeypatch)
    out = str(tmp_path / "inv")
    assert jax_cli(["invert-train", *_argv(tree, out), "--steps", "2"]) == 0
    _last_json(capsys)
    reports = {}
    lpips = ["--lpips-vgg", os.path.join(tree, "vgg16.pth"),
             "--lpips-lin", os.path.join(tree, "lin.pth")]
    overall = ["--overall", "--style-stats-dir", os.path.join(tree, "stats")]
    for tag, cli, extra in (("torch", torch_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        for mode, flags in (("plain", lpips), ("overall", overall)):
            assert cli(["invert-eval", *_argv(tree, out), *flags, *extra]) == 0
            reports[tag, mode] = _last_json(capsys)
    for mode in ("plain", "overall"):
        ours, theirs = reports["torch", mode], reports["jax", mode]
        n = "images" if mode == "plain" else "images_scored"
        assert ours[n] == theirs[n] == 12
        assert abs(ours["psnr_mean"] - theirs["psnr_mean"]) <= 1e-3
        np.testing.assert_allclose(ours["perceptual_mean"], theirs["perceptual_mean"], atol=1e-5)
    np.testing.assert_allclose(reports["torch", "plain"]["lpips_mean"],
                               reports["jax", "plain"]["lpips_mean"], atol=1e-5)
    recon_dir = reports["torch", "plain"]["recon_dir"]
    assert len([f for f in os.listdir(recon_dir) if f.startswith("recon_")]) == 12
    saved = np.load(os.path.join(recon_dir, "psnr_lpips.npy"), allow_pickle=True).item()
    assert len(saved["lpips_list"]) == 12 and saved["path_list"][0].endswith("img0.png")


def test_port_checkpoint_round_trip_and_holdout(tree, tmp_path, capsys):
    out = str(tmp_path / "inv")
    argv = _argv(tree, out)
    assert torch_cli(["invert-train", *argv, "--steps", "2", "--loss", "mse+perceptual",
                      "--device", "cpu"]) == 0
    best = _last_json(capsys)
    assert best["step"] == 1 and np.isfinite(best["final_loss"])
    assert torch_cli(["invert-eval", *argv, "--holdout", "--device", "cpu"]) == 0
    report = _last_json(capsys)
    val, _ = jinv._split_indices(jinv.InvertConfig(), 12)
    assert report["holdout"] and report["images"] == len(val)
    np.testing.assert_array_equal(tinv._split_indices(tinv.InvertConfig(), 12)[0], val)
    assert abs(report["psnr_mean"] - best["psnr"]) <= 1e-4
    # --target: another domain's list, held out by construction (--holdout ignored)
    assert torch_cli(["invert-eval", *argv, "--target", "photo", "--holdout",
                      "--device", "cpu"]) == 0
    report = _last_json(capsys)
    assert report["domain"] == "photo" and report["images"] == 5 and not report["holdout"]
    assert report["recon_dir"].endswith("recon_art_painting_to_photo")
    with pytest.raises(SystemExit, match="needs a coordinator"):
        torch_cli(["invert-train", *argv, "--num-procs", "2", "--device", "cpu"])
