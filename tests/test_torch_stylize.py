"""ccst_tpu_torch StylizeEngine and style-bank step on the CPU, held against
the committed goldens of ccst_tpu and the JAX engine, through the weight
bridge from the same PRNGKey(42/43) parameters.

Tolerances: float32 rtol=1e-4, atol=1e-5 (goldens and the JAX engine: same
math, sums in another order); bfloat16 port vs the bfloat16 JAX ``ref``
engine: MAE <= 1e-3, the BASELINE bar (bf16 rounds at other places, e.g. the
fused AdaIN rounds once where the JAX ops round twice); uint8 outputs within
one level. Where a bar is set for images in [0, 1], the random decoder's last
conv is rescaled so that the outputs spread over that range (``_spread``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.models import vgg as jvgg
from ccst_tpu.pipeline.stylize import StylizeEngine as JaxEngine
from ccst_tpu_torch.pipeline.stylize import StylizeEngine

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    enc = jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH)
    dec = jvgg.init_params(jax.random.PRNGKey(43), jvgg.DECODER_ARCH)
    return jax.tree.map(np.asarray, enc), jax.tree.map(np.asarray, dec)


def _spread(dec):
    """The decoder with its last conv scaled x20 and shifted by +0.5, so that
    stylized outputs span ~0.07..0.86 rather than +-0.02."""
    last = dec["dconv1_1"]
    return {**dec, "dconv1_1": {"w": last["w"] * 20, "b": last["b"] * 20 + 0.5}}


def _banks(rng, s):
    s_means = (rng.standard_normal((s, 512)) * 0.05).astype(np.float32)
    s_stds = (rng.random((s, 512)) * 0.1 + 0.02).astype(np.float32)
    return s_means, s_stds


def test_stylize_matches_golden(params):
    """The inputs of tests/test_golden.py::test_stylize_golden."""
    engine = StylizeEngine(*params, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1234)
    images = rng.random((1, 32, 32, 3), np.float32)
    s_mean = rng.standard_normal(512).astype(np.float32) * 0.05
    s_std = (rng.random(512).astype(np.float32) * 0.1 + 0.02).astype(np.float32)
    out = engine.stylize(torch.from_numpy(images), s_mean, s_std, 0.8)
    golden = np.load(os.path.join(GOLDEN_DIR, "stylize_32px.npz"))["out"]
    np.testing.assert_allclose(out.numpy(), golden, **TOL)


def test_style_bank_step_matches_golden(params):
    """The inputs of tests/test_golden.py::test_style_bank_golden."""
    from ccst_tpu_torch.ops.welford import welford_finalize, welford_init
    from ccst_tpu_torch.pipeline.style_bank import make_bank_step

    data = np.random.default_rng(99).random((4, 32, 32, 3)).astype(np.float32)
    step = make_bank_step(params[0], dtype=torch.float32)
    mean, std = welford_finalize(step(welford_init(512), torch.from_numpy(data), 4))
    golden = np.load(os.path.join(GOLDEN_DIR, "style_bank_32px.npz"))["out"]
    np.testing.assert_allclose(np.stack([mean.numpy(), std.numpy()]), golden, **TOL)


def test_stylize_multi_matches_jax_engine_f32(rng, params):
    images = rng.random((2, 32, 32, 3), np.float32)
    s_means, s_stds = _banks(rng, 3)
    ref = JaxEngine(*params, dtype=jnp.float32).stylize_multi(
        jnp.asarray(images), s_means, s_stds, 0.7
    )
    got = StylizeEngine(*params, dtype=torch.float32, device="cpu").stylize_multi(
        torch.from_numpy(images), s_means, s_stds, 0.7
    )
    assert got.shape == (3, 2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bf16_matches_jax_ref_engine(rng, params):
    enc, dec = params[0], _spread(params[1])
    images = rng.random((1, 32, 32, 3), np.float32)
    s_means, s_stds = _banks(rng, 1)
    ref = np.asarray(JaxEngine(enc, dec, dtype=jnp.bfloat16).stylize(
        jnp.asarray(images), s_means[0], s_stds[0], 1.0
    ))
    got = StylizeEngine(enc, dec, dtype=torch.bfloat16, device="cpu").stylize(
        torch.from_numpy(images), s_means[0], s_stds[0], 1.0
    )
    assert got.dtype == torch.float32
    assert ref.max() - ref.min() >= 0.5, (ref.min(), ref.max())
    mae = float(np.mean(np.abs(got.numpy() - ref)))
    assert mae <= 1e-3, mae


def test_uint8_transport_and_output(rng, params):
    """uint8 content in, uint8 images out (clamp, x255, +0.5, truncate),
    as the JAX engine's output_u8."""
    enc, dec = params[0], _spread(params[1])
    images = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    s_means, s_stds = _banks(rng, 1)
    ref = np.asarray(JaxEngine(enc, dec, dtype=jnp.float32, output_u8=True).stylize(
        jnp.asarray(images), s_means[0], s_stds[0], 1.0
    ))
    engine = StylizeEngine(enc, dec, dtype=torch.float32, device="cpu", output_u8=True)
    got = engine.stylize(torch.from_numpy(images), s_means[0], s_stds[0], 1.0)
    assert got.dtype == torch.uint8
    assert int(ref.max()) - int(ref.min()) >= 128, (ref.min(), ref.max())
    diff = np.abs(got.numpy().astype(int) - np.asarray(ref).astype(int))
    assert diff.max() <= 1


def test_style_stats_of_matches_jax(rng, params):
    image = rng.random((1, 32, 32, 3), np.float32)
    ref = JaxEngine(*params, dtype=jnp.float32).style_stats_of(jnp.asarray(image))
    got = StylizeEngine(*params, dtype=torch.float32, device="cpu").style_stats_of(
        torch.from_numpy(image)
    )
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("kw", [dict(engine="int8-static"), dict(output_size=96)])
def test_unported_options_raise(params, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StylizeEngine(*params, dtype=torch.float32, device="cpu", **kw)
