"""The AdaIN training objective of the port (``models/adain_net.py``) and its
autograd VGG route, held against ``ccst_tpu.models.adain_net`` on the same
JAX-initialized weights and seeded images (float32, 32 px, batch 2).

Tolerances: the losses within rtol 1e-4; every decoder gradient leaf within
1e-4 of that leaf's max |g| (the same maths, sums in another order); the
autograd route's taps within the kernel route's plain version at rtol 1e-4,
atol 1e-5; the SGD step (lr 1e-4) within 1e-4 of its update's max. The
frozen passes never hand a tensor that requires grad to the kernel wrappers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.models import adain_net as jnet
from ccst_tpu.models import vgg as jvgg
from ccst_tpu_torch.models import adain_net as tnet
from ccst_tpu_torch.models import vgg as tvgg
from tests.torch_parity import one_torch_thread  # noqa: F401

IMG, BATCH = 32, 2


@pytest.fixture(scope="module")
def setup():
    enc = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH))
    dec = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(43), jvgg.DECODER_ARCH))
    rng = np.random.default_rng(0)
    content = rng.uniform(0, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
    style = rng.uniform(0, 1, (BATCH, IMG, IMG, 3)).astype(np.float32) ** 2
    return enc, dec, content, style


def _jax_loss_and_grads(enc, dec, content, style, style_weight=10.0):
    def total(d):
        lc, ls = jnet.adain_losses(enc, d, jnp.asarray(content), jnp.asarray(style))
        return lc + style_weight * ls, (lc, ls)

    (_, (lc, ls)), g = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jax.tree.map(jnp.asarray, dec))
    return float(lc), float(ls), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("which", ["encoder_taps", "decoder"])
def test_autograd_route_matches_kernel_route(setup, which):
    enc, dec, content, _ = setup
    x = torch.from_numpy(content)
    if which == "encoder_taps":
        want = tvgg.encoder_taps(tvgg.prepare_params(enc, torch.float32, "cpu"), x)
        got = tvgg.encoder_taps(tvgg.trainable_params(enc, "cpu"), x, route="autograd")
        assert sorted(got) == sorted(want) == sorted(tvgg.TAPS)
    else:
        feat = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (BATCH, 4, 4, 512))
                                .astype(np.float32))
        want = {"out": tvgg.apply_decoder(tvgg.prepare_params(dec, torch.float32, "cpu"), feat)}
        got = {"out": tvgg.apply_decoder(tvgg.trainable_params(dec, "cpu"), feat,
                                         route="autograd")}
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5)


def test_trainable_params_round_trip(setup):
    _, dec, _, _ = setup
    trainable = tvgg.trainable_params(dec, "cpu")
    back = tvgg.params_from_trainable(trainable)
    src = {n: {k: torch.from_numpy(np.array(v)) for k, v in p.items()} for n, p in dec.items()}
    for p in tvgg.trainable_params(src, "cpu").values():
        with torch.no_grad():  # an optimizer's in-place update leaves the source alone
            p["w"].add_(1.0)
            p["b"].add_(1.0)
    for name in dec:
        for k in ("w", "b"):
            np.testing.assert_array_equal(back[name][k].numpy(), dec[name][k])
            np.testing.assert_array_equal(src[name][k].numpy(), dec[name][k])
    with pytest.raises(ValueError, match="route"):
        tvgg.apply_decoder(tvgg.trainable_params(dec, "cpu"), torch.zeros(1, 2, 2, 512),
                           route="cudnn")


def test_adain_losses_and_gradients_match_jax(setup):
    enc, dec, content, style = setup
    jlc, jls, jg = _jax_loss_and_grads(enc, dec, content, style)
    encoder = tnet.frozen_encoder(enc, "cpu")
    decoder = tvgg.trainable_params(dec, "cpu")
    lc, ls = tnet.adain_losses(encoder, decoder, torch.from_numpy(content),
                               torch.from_numpy(style))
    np.testing.assert_allclose(lc.item(), jlc, rtol=1e-4)
    np.testing.assert_allclose(ls.item(), jls, rtol=1e-4)
    leaves = tnet.decoder_leaves(decoder)
    grads = torch.autograd.grad(lc + 10.0 * ls, leaves)
    got = tvgg.params_from_trainable(
        {name: {"w": grads[2 * i], "b": grads[2 * i + 1]} for i, name in enumerate(decoder)})
    for name in dec:
        for k in ("w", "b"):
            g, want = got[name][k].numpy(), jg[name][k]
            scale = np.abs(want).max()
            assert np.abs(g - want).max() <= 1e-4 * scale, (name, k)


def test_sgd_step_matches_jax(setup):
    enc, dec, content, style = setup
    jdec, jloss = jax.jit(jnet.adain_train_step)(
        enc, jax.tree.map(jnp.asarray, dec), jnp.asarray(content), jnp.asarray(style))
    decoder = tvgg.trainable_params(dec, "cpu")
    loss = tnet.adain_train_step(tnet.frozen_encoder(enc, "cpu"), decoder,
                                 torch.from_numpy(content), torch.from_numpy(style))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    got = tvgg.params_from_trainable(decoder)
    for name in dec:
        for k in ("w", "b"):
            step = np.asarray(jdec[name][k]) - dec[name][k]
            err = np.abs(got[name][k].numpy() - np.asarray(jdec[name][k])).max()
            assert err <= 1e-4 * np.abs(step).max() + 1e-7, (name, k, err)


def test_frozen_passes_never_reach_a_kernel_with_grad(setup, monkeypatch):
    """The wrappers refuse a tensor that requires grad under grad mode; the
    losses' kernel-route passes run under no_grad, so they never trip it."""
    from ccst_tpu_torch.kernels import conv as kconv

    enc, dec, content, style = setup
    prepared = tvgg.prepare_params(enc, torch.float32, "cpu")
    x = torch.from_numpy(content).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tvgg.apply_encoder(prepared, x)
    seen = []
    real = kconv.reflect_conv3x3
    monkeypatch.setattr(tvgg, "reflect_conv3x3",
                        lambda x, cw, **k: seen.append(x.requires_grad) or real(x, cw, **k))
    tnet.adain_losses(tnet.frozen_encoder(enc, "cpu"), tvgg.trainable_params(dec, "cpu"),
                      torch.from_numpy(content), torch.from_numpy(style))
    assert len(seen) == 18 and not any(seen)


@pytest.mark.parametrize("deterministic", [False, True])
def test_reflect_pad_in_either_mode_equals_f_pad(deterministic):
    """The autograd route's reflect pad: ``F.pad``, or under cuDNN's
    deterministic mode slices and concatenations; the same values either way,
    and gradients within float32's rounding of ``F.pad``'s (a border element's
    gradient sums up to four terms, in another order)."""
    from ccst_tpu_torch.utils.precision import no_tf32

    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, 5, 4, 7)), dtype=torch.float32, requires_grad=True)
    g = torch.tensor(rng.standard_normal((2, 5, 6, 9)), dtype=torch.float32)
    with no_tf32(deterministic=deterministic):
        assert torch.backends.cudnn.deterministic == deterministic
        got = tvgg._reflect_pad1(x)
        (dx,) = torch.autograd.grad(got, x, g)
    want = torch.nn.functional.pad(x, (1, 1, 1, 1), mode="reflect")
    (dx_want,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(dx, dx_want, rtol=1e-6, atol=1e-6)
