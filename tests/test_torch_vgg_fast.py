"""ccst_tpu_torch.models.vgg_fast (the int8-static preparation, calibration and
scales files) held against ccst_tpu.models.vgg_fast on the same inputs.

Everything here is exact (``assert_array_equal``) except the float32
calibration pass: its convs sum in another order than XLA's, so the recorded
maxima agree to rtol 1e-5 under real style banks. Under the unit-stats
fallback (style std 1) AdaIN divides the content features by their own small
spatial std, which amplifies those last-bit differences: rtol 1e-4 there.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.models import vgg as jvgg
from ccst_tpu.models import vgg_fast as jf
from ccst_tpu_torch.models import vgg as tvgg
from ccst_tpu_torch.models import vgg_fast as tf


@pytest.fixture(scope="module")
def params():
    enc = jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH)
    dec = jvgg.init_params(jax.random.PRNGKey(43), jvgg.DECODER_ARCH)
    return jax.tree.map(np.asarray, enc), jax.tree.map(np.asarray, dec)


def _bf16(params):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)


def _scales(rng):
    names = list(jf._ENC_NEXT) + list(jf._DEC_NEXT)
    return {k: float(v) for k, v in zip(names, rng.uniform(0.5, 8.0, len(names)))}


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 4, 4, 64)])
def test_pack_unpack_match_jax(rng, shape):
    x = rng.standard_normal(shape, dtype=np.float32)
    packed = tf.pack_s2d(torch.from_numpy(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jf.pack_s2d(jnp.asarray(x))))
    back = tf.unpack_d2s(packed, shape[-1])
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        tf.phase_max(packed, shape[-1]).numpy(),
        np.asarray(jf.phase_max(jnp.asarray(np.asarray(packed)), shape[-1])),
    )


def test_pack_rejects_odd_sizes():
    with pytest.raises(ValueError, match="even"):
        tf.pack_s2d(torch.zeros((1, 5, 4, 3)))


def test_phase_max_int8_matches_jax(rng):
    x = rng.integers(-127, 128, (2, 3, 5, 4 * 64)).astype(np.int8)
    np.testing.assert_array_equal(
        tf.phase_max(torch.from_numpy(x), 64).numpy(),
        np.asarray(jf.phase_max(jnp.asarray(x), 64)),
    )


@pytest.mark.parametrize("name", ["conv1_1", "conv1_2", "dconv1_2", "dconv1_1", "conv2_1"])
def test_packed_kernels_match_jax(params, name):
    enc, dec = params
    w = (enc.get(name) or dec.get(name))["w"]
    np.testing.assert_array_equal(tf._packed_kernel_for(name, w), jf._packed_kernel_for(name, w))


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_prepare_q8s_matches_jax(rng, params, which):
    """The same bf16-cast weights and scales give the same int8 kernels and
    float32 epilogue terms, bit for bit."""
    raw = params[0] if which == "encoder" else params[1]
    scales = _scales(rng)
    theirs = getattr(jf, f"prepare_{which}_q8s")(_bf16(raw), scales)
    ours = getattr(tf, f"prepare_{which}_q8s")(tf.cast_params(raw, torch.bfloat16), scales)
    assert ours["__scales__"] == theirs["__scales__"]
    for name in raw:
        if name == "conv0":
            np.testing.assert_array_equal(
                ours[name].w.float().numpy(), np.asarray(theirs[name]["w"], np.float32)
            )
            continue
        q, j = ours[name], theirs[name]
        assert (q.packed, q.requant) == (j.packed, j.requant), name
        for field in ("wq", "k", "kb"):
            np.testing.assert_array_equal(getattr(q, field).numpy(), np.asarray(getattr(j, field)))


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_prepare_q8s_keeps_the_fused_level1_layouts(rng, params, which):
    """``"__level1__"`` holds the level-1 pair once more, packed for the fused
    kernel of that side (K1's or K2's layouts), and undoes to the layers."""
    from ccst_tpu_torch.kernels import igemm_layout as il
    from ccst_tpu_torch.kernels import level1

    raw = params[0] if which == "encoder" else params[1]
    prep = getattr(tf, f"prepare_{which}_q8s")(tf.cast_params(raw, torch.bfloat16), _scales(rng))
    lw = prep["__level1__"]
    if which == "encoder":
        assert isinstance(lw, level1.Level1Weights)
        order = torch.from_numpy(il.level1_column_order(64, 128))
        assert torch.equal(il.unpack_stage_tiles(lw.w2p, 256, 256), prep["conv1_2"].wq[..., order])
    else:
        assert isinstance(lw, level1.DecoderLevel1Weights)
        assert torch.equal(il.unpack_stage_tiles(lw.w1p, 64, 256), prep["dconv1_2"].wq)
        assert torch.equal(il.unpack_stage_tiles(lw.w2p, 256, 12), prep["dconv1_1"].wq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_static_matches_jax(rng, dtype):
    scale = 0.37 / 127.0
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32) * 0.3
    # exact half-way points: rint rounds them to even
    x[0, 0, 0, :4] = np.array([0.5, 1.5, -2.5, 200.0], np.float32) * np.float32(scale)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(getattr(torch, dtype))
    got = tf.quantize_static(xt, scale)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.quantize_static(xj, scale)))


@pytest.mark.parametrize("shape", [(2, 5, 7, 4), (1, 9, 9, 3), (1, 1, 3, 2)])
def test_maxpool_ceil_int8_odd_sizes(rng, shape):
    """Odd planes pad with the int8 minimum, as ccst_tpu.models.vgg does."""
    x = rng.integers(-128, 128, shape).astype(np.int8)
    got = tvgg.maxpool_ceil(torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jvgg.maxpool_ceil(jnp.asarray(x))))


@pytest.mark.parametrize("with_banks", [True, False])
def test_calibrate_scales_matches_jax(rng, params, with_banks):
    enc, dec = params
    images = rng.random((2, 32, 32, 3), np.float32)
    stats = None
    if with_banks:
        s_means = (rng.standard_normal((3, 512)) * 0.05).astype(np.float32)
        s_stds = (rng.random((3, 512)) * 0.1 + 0.02).astype(np.float32)
        stats = list(zip(s_means, s_stds))
    theirs = jf.calibrate_scales(
        _bf16(enc), _bf16(dec), jnp.asarray(images),
        None if stats is None else [(jnp.asarray(m), jnp.asarray(s)) for m, s in stats],
    )
    ours = tf.calibrate_scales(
        tf.cast_params(enc, torch.bfloat16), tf.cast_params(dec, torch.bfloat16),
        torch.from_numpy(images), stats,
    )
    assert set(ours) == set(theirs) == set(jf._ENC_NEXT) | set(jf._DEC_NEXT)
    rtol = 1e-5 if with_banks else 1e-4
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=rtol, err_msg=k)


def test_fingerprint_matches_jax(params):
    enc, dec = params
    fp = tf.weights_fingerprint(enc, dec)
    assert fp == jf.weights_fingerprint(enc, dec)
    # the same text from the bf16-cast copies and from torch tensors
    assert fp == tf.weights_fingerprint(tf.cast_params(enc, torch.bfloat16),
                                        tf.cast_params(dec, torch.bfloat16))
    assert fp != tf.weights_fingerprint(dec, enc)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_scales_file_round_trips_across_packages(tmp_path, rng, params, writer):
    enc, dec = params
    scales = _scales(rng)
    fp = tf.weights_fingerprint(enc, dec)
    path = str(tmp_path / "sub" / "scales.json")
    save = tf.save_scales if writer == "torch" else jf.save_scales
    save(path, scales, fingerprint=fp)
    with open(path) as f:
        assert json.load(f)["format"] == "ccst_tpu/q8s_scales/v1"
    for load in (tf.load_scales, jf.load_scales):
        assert load(path, expect_fingerprint=fp) == scales
        with pytest.raises(ValueError, match="different weights"):
            load(path, expect_fingerprint=fp + "0")


def test_int8_static_matches_golden(params):
    """The drift anchor of tests/test_golden.py::test_stylize_golden_int8_static
    through the port: calibrate on the float32 weights and the
    ``default_rng(11)`` inputs, int8-static encode -> AdaIN -> decode at 64 px,
    held to ``tests/goldens/stylize_64px_int8_static.npz`` with the same bar
    (mean |err| / span < 2e-3). The fused path equals the unfused one bit for
    bit."""
    import os

    from ccst_tpu_torch.ops.adain import adain_from_stats

    rng = np.random.default_rng(11)
    images = torch.from_numpy(rng.random((1, 64, 64, 3), np.float32))
    s_mean = rng.standard_normal(512).astype(np.float32) * 0.05
    s_std = rng.random(512).astype(np.float32) * 0.1 + 0.02
    enc, dec = (tf.cast_params(p, torch.float32) for p in params)
    scales = tf.calibrate_scales(enc, dec, images, [(s_mean, s_std)])
    eq = tf.prepare_encoder_q8s(enc, scales, torch.bfloat16, "cpu")
    dq = tf.prepare_decoder_q8s(dec, scales, torch.bfloat16, "cpu")
    out = tf.apply_decoder_q8s(dq, adain_from_stats(tf.apply_encoder_q8s(eq, images),
                                                    s_mean, s_std)).float()
    outf = tf.apply_decoder_q8s_fused(
        dq, adain_from_stats(tf.apply_encoder_q8s_fused(eq, images), s_mean, s_std)).float()
    assert torch.equal(out, outf)

    path = os.path.join(os.path.dirname(__file__), "goldens", "stylize_64px_int8_static.npz")
    golden = np.load(path)["out"].astype(np.float32)
    assert out.shape == golden.shape
    span = float(golden.max() - golden.min()) or 1.0
    err = np.abs(out.numpy() - golden)
    assert err.mean() / span < 2e-3, f"mean drift {err.mean() / span:.2e}"
