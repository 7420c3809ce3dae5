"""The port's lightweight GAN (``privacy/gan.py``, the ``gan-train``
subcommand) against ``ccst_tpu.privacy.gan`` on the CPU, float32.

- ``utils/optim.py::AdaBelief`` against ``optax.adabelief(b1=0.5, b2=0.9)``
  over 3 steps: rtol 1e-6;
- ``apply_augment`` with JAX's draws injected (each policy's uniforms and
  integer offsets drawn from the keys ``diff_augment`` splits): 1e-6;
- one ``GanTrainer`` step at 32 px with the R1 penalty on (step 0) and
  ``attn_res=(16,)`` in G and D, from JAX's initial parameters, with JAX's
  latents and augment draws injected: the six losses within rtol 1e-4; every
  parameter of G, D and the EMA copy with median error under 1e-3 lr and none
  beyond 4 lr (a first AdaBelief step with b1 = 0.5, b2 = 0.9 is about
  -2 lr sign(g), so only gradients near zero may land elsewhere);
- the VGG relu4_1 features of ``vgg_frechet_distance`` within 1e-5 and the
  distance within rtol 1e-3 (a covariance of 6 samples in 512 dimensions
  is rank-deficient, and its square roots amplify float32 rounding);
- ``gan-train`` and ``save_augment_grid`` write what they promise.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ccst_tpu.data.lists import write_list
from ccst_tpu.data.loader import save_image_u8
from ccst_tpu.models import vgg as jvgg
from ccst_tpu.privacy import gan as jgan
from ccst_tpu_torch.cli import main as torch_cli
from ccst_tpu_torch.privacy import gan as tgan
from ccst_tpu_torch.privacy.generator import from_flax
from ccst_tpu_torch.utils.optim import AdaBelief
from tests.torch_parity import jit_flax_init, one_torch_thread, pinned_io_tier  # noqa: F401

POLICY = "color,translation,cutout"


def jax_draws(key, n, h, w, policy=POLICY):
    """The draws ``ccst_tpu.privacy.gan.diff_augment(key, x, policy)`` takes,
    in the port's form."""
    t = lambda a: torch.from_numpy(np.asarray(a).reshape(n).copy())  # noqa: E731
    out = []
    for name in policy.split(","):
        key, sub = jax.random.split(key)
        if name == "color":
            kb, ks, kc = jax.random.split(sub, 3)
            u = lambda k, lo, hi: t(jax.random.uniform(k, (n, 1, 1, 1), minval=lo, maxval=hi))  # noqa: E731
            out.append((name, {"brightness": u(kb, -0.5, 0.5), "saturation": u(ks, 0.0, 2.0),
                               "contrast": u(kc, 0.5, 1.5)}))
        elif name == "translation":
            sh, sw = int(h * 0.125) + 1, int(w * 0.125) + 1
            kx, ky = jax.random.split(sub)
            out.append((name, {"tx": t(jax.random.randint(kx, (n,), -sh + 1, sh)),
                               "ty": t(jax.random.randint(ky, (n,), -sw + 1, sw))}))
        else:
            ch, cw = int(h * 0.5), int(w * 0.5)
            kx, ky = jax.random.split(sub)
            out.append((name, {"ox": t(jax.random.randint(kx, (n, 1, 1), 0, h - ch + 1)),
                               "oy": t(jax.random.randint(ky, (n, 1, 1), 0, w - cw + 1))}))
    return out


def test_adabelief_matches_optax():
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    tx = optax.adabelief(1e-3, b1=0.5, b2=0.9)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = AdaBelief(tp, 1e-3, b1=0.5, b2=0.9)
    for k in range(3):
        g = [rng.normal(size=p.shape).astype(np.float32) * 10.0 ** -k for p in params]
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(x) for x in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("policy", ["color", "translation", "cutout", POLICY])
def test_diff_augment_with_jax_draws(policy):
    x = np.random.default_rng(1).uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jgan.diff_augment(key, jnp.asarray(x), policy))
    got = tgan.apply_augment(torch.from_numpy(x), jax_draws(key, 3, 24, 20, policy)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the port's own draws take the same forms and ranges
    draws = tgan.sample_augment(torch.Generator().manual_seed(0), 3, 24, 20, policy)
    assert [n for n, _ in draws] == policy.split(",")
    assert tgan.diff_augment(torch.Generator().manual_seed(0), torch.from_numpy(x),
                             policy).shape == x.shape


def test_gan_step_with_penalty_matches_jax(monkeypatch):
    cfg = dict(image_size=32, latent_dim=32, batch_size=2, fmap_max=64, gp_weight=10.0,
               attn_res=(16,), seed=0)
    jit_flax_init(monkeypatch)
    jt = jgan.GanTrainer(jgan.GanConfig(**cfg))
    g0, d0 = jax.tree.map(np.asarray, jt.g_params), jax.tree.map(np.asarray, jt.d_params)
    real = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    # the step's key as GanTrainer.train_step splits it, then its draws
    _, sub = jax.random.split(jax.random.split(jax.random.PRNGKey(0), 3)[2])
    kd, kg = jax.random.split(sub)
    kz, ka1, ka2 = jax.random.split(kd, 3)
    kzg, kag = jax.random.split(kg)
    draws = {"z_d": torch.from_numpy(np.array(jax.random.normal(kz, (2, 32)))),
             "aug_real": jax_draws(ka1, 2, 32, 32), "aug_fake": jax_draws(ka2, 2, 32, 32),
             "z_g": torch.from_numpy(np.array(jax.random.normal(kzg, (2, 32)))),
             "aug_g": jax_draws(kag, 2, 32, 32)}
    want = jt.train_step(real, step_idx=0)
    tt = tgan.GanTrainer(tgan.GanConfig(**cfg), device="cpu")
    tt.load_flax(g0, d0)
    got = tt.train_step(torch.from_numpy(real), step_idx=0, draws=draws)
    assert sorted(got) == sorted(want) and got["gp"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    lr = 2e-4
    for module, tree in ((tt.gen, jt.g_params), (tt.disc, jt.d_params), (tt.g_ema, jt.g_ema)):
        ref = from_flax(jax.tree.map(np.asarray, tree))
        for k, v in module.state_dict().items():
            err = (v - ref[k]).abs()
            assert float(err.median()) <= 1e-3 * lr and float(err.max()) <= 4 * lr, k


def test_vgg_frechet_distance_matches_jax(monkeypatch):
    enc = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH))
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (6, 32, 32, 3)).astype(np.float32)
    b = (rng.uniform(0, 1, (6, 32, 32, 3)) ** 2).astype(np.float32)
    # the JAX function's encoder, jitted (eager, it dispatches op by op)
    encode = jax.jit(jvgg.apply_encoder)
    monkeypatch.setattr(jvgg, "apply_encoder", encode)
    got_f = tgan.vgg_features(enc, a, "cpu")
    want_f = np.asarray(jnp.mean(encode(enc, jnp.asarray(a)), axis=(1, 2)))
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=1e-5)
    want = jgan.vgg_frechet_distance(enc, a, b)
    got = tgan.vgg_frechet_distance(enc, a, b, device="cpu")
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert tgan.frechet_distance(got_f, got_f) < 1e-3 * want


def test_gan_train_cli_and_augment_grid(tmp_path, capsys):
    root = str(tmp_path)
    names = []
    rng = np.random.default_rng(4)
    for i in range(4):
        rel = f"PACS/kfold/art_painting/dog/img{i}.png"
        save_image_u8(rng.uniform(0, 1, (36, 36, 3)).astype(np.float32), os.path.join(root, rel))
        names.append(rel)
    write_list(os.path.join(root, "txt_lists", "pacs", "art_painting_train.txt"), names, [0] * 4)
    out = os.path.join(root, "gan")
    assert torch_cli(["gan-train", "--list-root", root, "--data-root", root, "--out-dir", out,
                      "--image-size", "32", "--latent-dim", "16", "--fmap-max", "32",
                      "--batch-size", "2", "--steps", "2", "--gp-weight", "10",
                      "--attn-res", "16", "--fid-samples", "3", "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["steps"] == 2 and np.isfinite(printed["fid_vgg"])
    assert printed["gp"] == 0.0  # step 1: the penalty runs every 4th step
    assert all(os.path.exists(os.path.join(out, f"sample_{i}.png")) for i in range(4))
    state = torch.load(os.path.join(out, "gan_pacs_art_painting.pt"), weights_only=True)
    assert state["config"] == {"image_size": 32, "latent_dim": 16, "fmap_max": 32}
    logged = [json.loads(l) for l in open(os.path.join(out, "gan_pacs_art_painting.jsonl"))]
    assert [r["step"] for r in logged] == [0] and logged[0]["gp"] > 0
    grid = tgan.save_augment_grid(np.stack([np.full((8, 8, 3), 0.5, np.float32)] * 2),
                                  str(tmp_path / "grid.png"))
    from PIL import Image

    assert np.asarray(Image.open(grid)).shape == (4 * 8, 2 * 8, 3)
