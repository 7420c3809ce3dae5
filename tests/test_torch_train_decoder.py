"""Decoder training of the port (``pipeline/train_decoder.py``, the
``train-decoder`` subcommand) against ``ccst_tpu``'s, on the CPU.

- ``utils/optim.py::Adam`` against ``optax.adam`` over 3 steps of seeded
  gradients: rtol 1e-6 (the same float32 operations in the same order);
- 3 Adam steps of the decoder from the same batches and weights
  (``DecoderTrainer.step`` against optax around ``adain_losses``): the
  losses of each step within rtol 1e-4, every leaf within 1e-6 absolute (an
  Adam update is +-lr = 1e-4 a step where the gradient is not tiny; float
  rounding flips the sign of a near-zero moment only);
- both CLIs on a tiny tree (4 domains x 6 PNGs at 40 -> 32 px, batch 2, 3
  steps, the same ``.npz`` weights in, the IO tier pinned so that both read the
  same pixels and so the same batches): the final losses within rtol 1e-3 and
  every ``.npz`` leaf within atol 2 lr steps; the port's ``.npz`` loads in
  ``ccst_tpu`` with the tree of its own decoder, and ``ccst_tpu``'s in the
  port, which decodes with it as ``ccst_tpu`` does (rtol 1e-4, atol 1e-5).
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
from ccst_tpu.models import adain_net as jnet
from ccst_tpu.models import convert as jconvert
from ccst_tpu.models import vgg as jvgg
from ccst_tpu_torch.cli import main as torch_cli
from ccst_tpu_torch.models import convert as tconvert
from ccst_tpu_torch.models import vgg as tvgg
from ccst_tpu_torch.pipeline.train_decoder import DecoderTrainConfig, DecoderTrainer
from ccst_tpu_torch.utils.optim import Adam
from tests.torch_parity import one_torch_thread, pinned_io_tier  # noqa: F401

DOMAINS = ["art_painting", "cartoon", "photo", "sketch"]
IMG, BATCH, STEPS, LR = 32, 2, 3, 1e-4


@pytest.fixture(scope="module")
def weights():
    enc = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH))
    dec = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(43), jvgg.DECODER_ARCH))
    return enc, dec


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * 10 ** -k for p in params]
             for k in range(STEPS)]
    tx = optax.adam(1e-3)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = Adam(tp, 1e-3)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(x) for x in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_three_adam_steps_match_jax(weights):
    enc, dec = weights
    rng = np.random.default_rng(1)
    batches = [(rng.uniform(0, 1, (BATCH, IMG, IMG, 3)).astype(np.float32),
                rng.uniform(0, 1, (BATCH, IMG, IMG, 3)).astype(np.float32) ** 2)
               for _ in range(STEPS)]
    tx = optax.adam(LR)

    @jax.jit
    def jstep(d, opt_state, content, style):
        def total(p):
            lc, ls = jnet.adain_losses(enc, p, content, style)
            return lc + 10.0 * ls, (lc, ls)

        (_, (lc, ls)), g = jax.value_and_grad(total, has_aux=True)(d)
        upd, opt_state = tx.update(g, opt_state, d)
        return optax.apply_updates(d, upd), opt_state, lc, ls

    jd = jax.tree.map(jnp.asarray, dec)
    js = tx.init(jd)
    trainer = DecoderTrainer(DecoderTrainConfig(lr=LR), enc, dec, "cpu")
    for content, style in batches:
        jd, js, jlc, jls = jstep(jd, js, jnp.asarray(content), jnp.asarray(style))
        lc, ls = trainer.step(torch.from_numpy(content), torch.from_numpy(style))
        np.testing.assert_allclose([float(lc), float(ls)], [float(jlc), float(jls)], rtol=1e-4)
    got = tvgg.params_from_trainable(trainer.decoder)
    for name in dec:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[name][k].numpy(), np.asarray(jd[name][k]), rtol=0,
                                       atol=1e-6, err_msg=f"{name}/{k}")


@pytest.fixture(scope="module")
def tree(tmp_path_factory, weights):
    root = str(tmp_path_factory.mktemp("pacs"))
    rng = np.random.default_rng(0)
    for d in DOMAINS:
        names = []
        for i in range(6):
            rel = f"PACS/kfold/{d}/dog/img{i}.png"
            save_image_u8(np.clip(rng.normal(0.2 + 0.1 * i, 0.2, (40, 40, 3)), 0, 1)
                          .astype(np.float32), os.path.join(root, rel))
            names.append(rel)
        write_list(os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt"), names, [0] * 6)
    enc, dec = weights
    jconvert.save_npz(os.path.join(root, "enc.npz"), enc)
    jconvert.save_npz(os.path.join(root, "dec.npz"), dec)
    return root


def test_train_decoder_cli_matches_jax_cli(tree, tmp_path, capsys):
    outs = {}
    for tag, cli, extra in (("torch", torch_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
        out = str(tmp_path / f"{tag}.npz")
        assert cli(["train-decoder", "--dataset", "pacs", "--list-root", tree, "--data-root",
                    tree, "--image-size", str(IMG), "--batch-size", str(BATCH), "--steps",
                    str(STEPS), "--lr", str(LR), "--domains", "art_painting,cartoon,sketch",
                    "--vgg-weights", os.path.join(tree, "enc.npz"), "--init-decoder",
                    os.path.join(tree, "dec.npz"), "--out-path", out, *extra]) == 0
        outs[tag] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert outs[tag]["out_path"] == out
    for k in ("final_loss_c", "final_loss_s"):
        np.testing.assert_allclose(outs["torch"][k], outs["jax"][k], rtol=1e-3)
    ours = jconvert.load_decoder(outs["torch"]["out_path"])
    theirs = jconvert.load_decoder(outs["jax"]["out_path"])
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for name in theirs:
        for k in ("w", "b"):
            a, b = np.asarray(ours[name][k]), np.asarray(theirs[name][k])
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * STEPS)
    # the port's decoder drives ccst_tpu's decoder, and ccst_tpu's the port's
    feat = np.random.default_rng(5).uniform(0, 1, (1, 2, 2, 512)).astype(np.float32)
    want = np.asarray(jvgg.apply_decoder(ours, jnp.asarray(feat)))
    theirs_t = tconvert.load_decoder(outs["jax"]["out_path"])
    got = tvgg.apply_decoder(tvgg.prepare_params(theirs_t, torch.float32, "cpu"),
                             torch.from_numpy(feat)).numpy()
    assert want.shape == got.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(got, np.asarray(jvgg.apply_decoder(theirs, jnp.asarray(feat))),
                               rtol=1e-4, atol=1e-5)
