"""The training stage's image ops of the port against ``ccst_tpu``'s:
RandomResizedCrop (with JAX's own boxes), flip, normalize and resize
(``ops/image.py``); the Jigsaw shuffle and its permutation asset
(``data/jigsaw.py``); the FedDG frequency augment with injected picks and
ratios (``ops/fft_aug.py``).

Tolerances: the resamplers within 1e-5 of JAX on [0, 1] images (float32
sums in another order); the Jigsaw shuffle exact; the FFT augment within 1e-4
on [0, 1] outputs (float32 FFTs of [0, 255] images).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.data import jigsaw as jjig
from ccst_tpu.ops import fft_aug as jfft
from ccst_tpu.ops import image as jimg
from ccst_tpu_torch.data import jigsaw as tjig
from ccst_tpu_torch.ops import fft_aug as tfft
from ccst_tpu_torch.ops import image as timg

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: the suite runs in several
    workers at once, and each torch's default of a thread a core oversubscribes
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(n, h, w, seed=0):
    return np.random.default_rng(seed).random((n, h, w, 3), np.float32)


def _jax_boxes(key, n, h, w, scale, ratio=(3 / 4, 4 / 3)):
    """The boxes ccst_tpu.random_resized_crop draws for ``key``: one split key
    an image, ``_sample_crop_box`` on each."""
    keys = jax.random.split(key, n)
    return np.array([[float(v) for v in jimg._sample_crop_box(k, h, w, scale, ratio)]
                     for k in keys], np.float32)


@pytest.mark.parametrize("h,w,out,scale", [(40, 36, 32, (0.08, 1.0)), (48, 48, 48, (0.8, 1.0)),
                                           (20, 24, 33, (0.5, 1.0))],
                         ids=["down", "same-size", "up"])
def test_crop_resize_with_jax_boxes(h, w, out, scale):
    x = _images(5, h, w)
    key = jax.random.PRNGKey(h + w)
    want = np.asarray(jimg.random_resized_crop(key, jnp.asarray(x), out, scale))
    boxes = _jax_boxes(key, 5, h, w, scale)
    got = timg.crop_resize(torch.from_numpy(x), torch.from_numpy(boxes), out).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_train_transform_with_jax_draws():
    """Crop, flip and normalize with the boxes and flips of JAX's own keys."""
    x = _images(6, 40, 40, seed=1)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jimg.train_transform(key, jnp.asarray(x), 32, 0.8, 1.0))
    k_crop, k_flip = jax.random.split(key)
    boxes = _jax_boxes(k_crop, 6, 40, 40, (0.8, 1.0))
    flips = np.array(jax.random.bernoulli(k_flip, 0.5, (6,)))
    assert 0 < flips.sum() < 6
    t = timg.crop_resize(torch.from_numpy(x), torch.from_numpy(boxes), 32)
    got = timg.normalize(timg.flip(t, torch.from_numpy(flips))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_sampled_boxes_stay_inside_and_follow_the_scale():
    gen = torch.Generator().manual_seed(0)
    boxes = timg.sample_crop_boxes(gen, 4000, 50, 60, (0.3, 1.0)).numpy()
    y0, x0, ch, cw = boxes.T
    assert (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + ch <= 50 + 1e-4).all() and (x0 + cw <= 60 + 1e-4).all()
    area = ch * cw / (50 * 60)
    assert area.min() >= 0.3 * 0.99 and area.max() <= 1.0 + 1e-5
    aspect = cw / ch
    assert aspect.min() >= 3 / 4 * 0.99 or area.max() > 0.9  # clamped boxes only at full size
    flips = timg.sample_flips(gen, 4000).numpy()
    assert 0.45 < flips.mean() < 0.55
    again = timg.sample_crop_boxes(torch.Generator().manual_seed(0), 4000, 50, 60, (0.3, 1.0))
    np.testing.assert_array_equal(again.numpy(), boxes)


@pytest.mark.parametrize("side", [40, 32], ids=["resize", "identity"])
def test_eval_transform_and_normalize(side):
    x = _images(3, 40, 40, seed=2)
    want = np.asarray(jimg.eval_transform(jnp.asarray(x), side))
    got = timg.eval_transform(torch.from_numpy(x), side).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(timg.normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jimg.normalize(jnp.asarray(x))), rtol=0, atol=1e-6)


# ---- jigsaw ---------------------------------------------------------------


def test_permutation_tables_equal_jax():
    np.testing.assert_array_equal(tjig.permutation_set(30), jjig.permutation_set(30))
    np.testing.assert_array_equal(tjig.permutation_set(12, seed=1), jjig.permutation_set(12, seed=1))


def test_tile_and_permute_equals_jax():
    x = _images(31, 36, 45, seed=3)
    orders = np.arange(31)
    perms = jjig.permutation_set(30)
    want = np.asarray(jjig.tile_and_permute(jnp.asarray(x), jnp.asarray(orders), jnp.asarray(perms)))
    got = tjig.tile_and_permute(torch.from_numpy(x), torch.from_numpy(orders),
                                torch.from_numpy(tjig.permutation_set(30))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], x[0])
    with pytest.raises(ValueError, match="divisible"):
        tjig.tile_and_permute(torch.zeros(1, 10, 9, 3), torch.zeros(1, dtype=torch.long),
                              torch.from_numpy(perms))


def test_sample_orders_bias():
    orders = tjig.sample_orders(torch.Generator().manual_seed(1), 20000, 30, 0.9).numpy()
    assert orders.min() == 0 and orders.max() == 30
    # P(order = 0) = 0.9 + 0.1 / 31
    assert abs((orders == 0).mean() - (0.9 + 0.1 / 31)) < 0.01


# ---- FedDG frequency augment ----------------------------------------------


def test_amplitude_and_low_freq_mutate_equal_jax():
    x = _images(2, 24, 20, seed=4) * 255
    for i in range(2):
        np.testing.assert_allclose(tfft.amplitude_spectrum(torch.from_numpy(x[i])).numpy(),
                                   np.asarray(jfft.amplitude_spectrum(jnp.asarray(x[i]))),
                                   rtol=1e-5, atol=1e-2)
    a = np.abs(np.random.default_rng(5).normal(size=(2, 3, 24, 20))).astype(np.float32)
    for L in (0.0, 0.1, 0.6):
        want = np.asarray(jfft.low_freq_mutate(jnp.asarray(a[0]), jnp.asarray(a[1]),
                                               jnp.float32(0.3), L=L))
        got = tfft.low_freq_mutate(torch.from_numpy(a[0]), torch.from_numpy(a[1]), 0.3, L=L)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_feddg_augment_with_injected_draws():
    x = _images(5, 24, 24, seed=6)
    bank = np.abs(np.random.default_rng(7).normal(size=(4, 3, 24, 24))).astype(np.float32) * 500
    picks = np.array([0, 3, 1, 1, 2])
    ratios = np.array([0.1, 0.9, 0.5, 0.3, 0.7], np.float32)
    want = jax.vmap(lambda img, p, r: jfft.source_to_target_freq(img * 255.0, jnp.asarray(bank)[p], r)
                    / 255.0)(jnp.asarray(x), jnp.asarray(picks), jnp.asarray(ratios))
    got = tfft.feddg_augment(torch.from_numpy(x), torch.from_numpy(bank), torch.from_numpy(picks),
                             torch.from_numpy(ratios))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert not np.allclose(got.numpy(), x, atol=1e-3)
    picks, ratios = tfft.sample_feddg_draws(torch.Generator().manual_seed(0), 5000, 4)
    assert set(picks.tolist()) == {0, 1, 2, 3}
    assert set(np.round(ratios.numpy() * 10).astype(int).tolist()) == set(range(1, 10))
