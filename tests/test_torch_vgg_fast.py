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


# ---- the packed engine (float32: exact to float tolerance) ----------------
#
# Tolerances: the port's packed encoder / decoder against ccst_tpu's in
# float32, atol 2e-5 (tests/test_vgg_fast.py's bar for packed vs ref: the same
# products, sums in another order); a packed conv against ccst_tpu's
# packed_reflect_conv, rtol 1e-4 / atol 1e-5 (one layer).


def _packed_prep(params, which, dtype=torch.float32):
    enc, dec = params
    if which == "encoder":
        return tf.prepare_encoder(tf.cast_params(enc, dtype), dtype, "cpu"), jf.prepare_encoder(
            jax.tree.map(jnp.asarray, enc))
    return tf.prepare_decoder(tf.cast_params(dec, dtype), dtype, "cpu"), jf.prepare_decoder(
        jax.tree.map(jnp.asarray, dec))


@pytest.mark.parametrize("name", ["conv1_1", "conv1_2", "dconv1_2", "dconv1_1"])
def test_packed_conv_matches_jax_packed_reflect_conv(rng, params, name):
    """K3's plain version with edge padding on the packed kernel is
    ccst_tpu's packed_reflect_conv (conv1_1 with its zero channels 12..15)."""
    which = "encoder" if name.startswith("conv") else "decoder"
    ours, theirs = _packed_prep(params, which)
    cin = theirs[name]["K"].shape[2]
    x = (rng.random((2, 6, 5, cin), np.float32) - 0.3).astype(np.float32)
    relu = name != "dconv1_1"
    ref = np.asarray(jf.packed_reflect_conv(jnp.asarray(x), theirs[name]["K"],
                                            theirs[name]["b"], relu=relu))
    xt = torch.from_numpy(x)
    if name == "conv1_1":
        assert ours[name].w.shape[2] == tf.PACKED_CIN == 16 > cin
        xt = torch.nn.functional.pad(xt, (0, tf.PACKED_CIN - cin))
    got = tf.packed_reflect_conv(xt, ours[name], relu)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_packed_engine_matches_jax_float32(rng, params, which):
    ours, theirs = _packed_prep(params, which)
    if which == "encoder":
        x = rng.random((2, 32, 32, 3), np.float32)
        ref = jf.apply_encoder_packed(theirs, jnp.asarray(x), jnp.float32)
        got = tf.apply_encoder_packed(ours, torch.from_numpy(x), torch.float32)
    else:
        x = (rng.random((2, 4, 4, 512), np.float32) * 0.5).astype(np.float32)
        ref = jf.apply_decoder_packed(theirs, jnp.asarray(x), jnp.float32)
        got = tf.apply_decoder_packed(ours, torch.from_numpy(x), torch.float32)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def test_packed_engine_refuses_odd_sizes(params):
    """As ccst_tpu refuses them (tests/test_vgg_fast.py::test_packed_rejects_odd_sizes)."""
    ours, _ = _packed_prep(params, "encoder")
    with pytest.raises(ValueError, match="even"):
        tf.apply_encoder_packed(ours, torch.zeros((1, 33, 32, 3)), torch.float32)


# ---- the dynamic int8 engine: bit for bit per layer ------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_matches_jax(rng, dtype):
    x = (rng.standard_normal((2, 5, 7, 64)) * 3).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q_ref, s_ref = jf._quantize_act(jnp.asarray(np.asarray(xt.float()), getattr(jnp, dtype)))
    q, s = tf._quantize_act(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    assert float(s) == float(s_ref)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))


# (layer, input (N, H, W, Cin), pad, relu, out dtype): the packed conv1_1 (K0's
# 4-byte gather, Cin = 12), a reflect layer, conv4_1, the folded dconv1_2 and
# the packed dconv1_1 (no ReLU, Cout = 12)
Q8_CASES = [
    ("conv1_1", (2, 4, 6, 12), "edge", True, "float32"),
    ("conv2_1", (2, 5, 3, 64), "reflect", True, "float32"),
    ("conv4_1", (1, 4, 4, 256), "reflect", True, "bfloat16"),
    ("dconv1_2", (1, 4, 5, 64), "edge", True, "bfloat16"),
    ("dconv1_1", (2, 3, 4, 256), "edge", False, "float32"),
]


@pytest.mark.parametrize("name,shape,pad,relu,out", Q8_CASES)
def test_qconv_apply_matches_jax(rng, params, name, shape, pad, relu, out):
    """One conv of the dynamic engine: quantize, K0's plain version with the
    device-resident scale, dequant; the same bits as ccst_tpu's
    ``_qconv_apply`` on the same float input and the same prepared layer."""
    which = 0 if name.startswith("conv") else 1
    cast = tf.cast_params(params[which], getattr(torch, out))
    ours = (tf.prepare_encoder_q8 if which == 0 else tf.prepare_decoder_q8)(
        cast, getattr(torch, out), "cpu")[name]
    theirs = (jf.prepare_encoder_q8 if which == 0 else jf.prepare_decoder_q8)(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in cast.items()})[name]
    np.testing.assert_array_equal(ours.wq.numpy(), np.asarray(theirs.wq))
    np.testing.assert_array_equal(ours.k.numpy(), np.asarray(theirs.w_scale))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(getattr(torch, out))
    ref = jf._qconv_apply(jnp.asarray(np.asarray(x.float()), getattr(jnp, out)), theirs, relu,
                          getattr(jnp, out), pad)
    got = tf._qconv_apply(x, ours, relu, getattr(torch, out), pad)
    assert got.dtype == getattr(torch, out) and got.shape[-1] == ref.shape[-1]
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_dynamic_engine_scale_stays_on_the_device(rng, params, monkeypatch):
    """Every conv of the int8 engine hands K0 a multiplier ``w_scale *
    a_scale`` formed on the input's device (one float32 value a channel), and
    nothing reads a tensor back to the host on the way: ``Tensor.item`` and
    ``float(tensor)`` raise here."""
    seen = []
    conv = tf.qconv3x3_s8

    def spy(x, q, relu, out_dtype, pad_mode):
        seen.append((q.k.dtype, q.k.shape == q.kb.shape, q.k.device == x.device, pad_mode))
        return conv(x, q, relu, out_dtype, pad_mode)

    def no_host_read(*args, **kwargs):
        raise AssertionError("a tensor was read back to the host")

    enc, dec = (tf.cast_params(p, torch.bfloat16) for p in params)
    ep = tf.prepare_encoder_q8(enc, torch.bfloat16, "cpu")
    dp = tf.prepare_decoder_q8(dec, torch.bfloat16, "cpu")
    images = torch.from_numpy(rng.random((1, 16, 16, 3), np.float32))
    monkeypatch.setattr(tf, "qconv3x3_s8", spy)
    monkeypatch.setattr(torch.Tensor, "item", no_host_read)
    monkeypatch.setattr(torch.Tensor, "__float__", no_host_read)
    out = tf.apply_decoder_q8(dp, tf.apply_encoder_q8(ep, images))
    assert out.shape == (1, 16, 16, 3)
    assert len(seen) == 18 and {s[:3] for s in seen} == {(torch.float32, True, True)}
    assert [s[3] for s in seen] == ["edge"] * 2 + ["reflect"] * 14 + ["edge"] * 2
