"""ccst_tpu_torch StylizeEngine and style-bank step on the CPU, held against
the committed goldens of ccst_tpu and the JAX engine, through the weight
bridge from the same PRNGKey(42/43) parameters.

Tolerances: float32 rtol=1e-4, atol=1e-5 (goldens and the JAX engine: same
math, sums in another order); bfloat16 port vs the bfloat16 JAX ``ref``
engine: MAE <= 1e-3, the BASELINE bar (bf16 rounds at other places, e.g. the
fused AdaIN rounds once where the JAX ops round twice); uint8 outputs within
one level. The int8 engines: the port's ``int8-static`` vs JAX's with the same
scales at MAE <= 1e-3 (conv0's three-term float32 sum can round differently
before ``quantize_static`` and flip an int8 step, and AdaIN rounds as above);
the port's ``int8-fused`` equals its ``int8-static`` bit for bit. The ``packed`` engine in float32 against ccst_tpu's
``packed`` engine and against the port's float32 ``ref`` engine: atol 5e-5
(ccst_tpu's own bar for packed vs ref, tests/test_vgg_fast.py); in bfloat16
MAE <= 1e-3. The dynamic ``int8`` engine against ccst_tpu's: MAE <= 1e-3 (in
float32 the fused AdaIN's last bits can flip one rounding of the next
``x / s``; each conv alone is bit for bit, tests/test_torch_vgg_fast.py).
``resize_bilinear`` against ``jax.image.resize``: atol 1e-5; the engines with
``output_size`` as their float32 bar. ``coral`` against ccst_tpu's: float32,
atol 1e-5. Where a bar is set for images in [0, 1], the random decoder's last
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stylize_multi_is_one_adain_launch_and_equals_stylize_per_style(
        rng, params, dtype, monkeypatch):
    """One call of the S-style AdaIN for the whole bank, and exactly the
    outputs of S single-style ``stylize`` calls."""
    from ccst_tpu_torch.pipeline import stylize as mod

    calls = []
    multi = mod.fused_adain_multi
    monkeypatch.setattr(mod, "fused_adain_multi",
                        lambda *a, **kw: calls.append(a[1].shape) or multi(*a, **kw))
    images = torch.from_numpy(rng.random((2, 16, 16, 3), np.float32))
    s_means, s_stds = _banks(rng, 3)
    engine = StylizeEngine(params[0], _spread(params[1]), dtype=dtype, device="cpu")
    got = engine.stylize_multi(images, s_means, s_stds, 0.7)
    assert calls == [(3, 512)]
    for s in range(3):
        assert torch.equal(got[s], engine.stylize(images, s_means[s], s_stds[s], 0.7))


def test_float32_ref_engine_matches_jax_float32_engine(rng, params):
    """The parity mode (``--dtype float32``): the port's float32 ``ref``
    engine against ccst_tpu's at 32 px, on outputs that spread over [0, 1];
    MAE <= 1e-5 (the same float32 maths, sums in another order)."""
    enc, dec = params[0], _spread(params[1])
    images = rng.random((2, 32, 32, 3), np.float32)
    s_means, s_stds = _banks(rng, 2)
    ref = np.asarray(JaxEngine(enc, dec, dtype=jnp.float32).stylize_multi(
        jnp.asarray(images), s_means, s_stds, 1.0))
    engine = StylizeEngine(enc, dec, dtype=torch.float32, device="cpu")
    assert all(cw.w.dtype == torch.float32 and (cw.packed is None or cw.packed.dtype == torch.float32)
               for cw in (*engine.enc.values(), *engine.dec.values()))
    got = engine.stylize_multi(torch.from_numpy(images), s_means, s_stds, 1.0)
    assert got.dtype == torch.float32 and ref.max() - ref.min() >= 0.5
    mae = float(np.mean(np.abs(got.numpy() - ref)))
    assert mae <= 1e-5, mae


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


def test_int8_engine_style_stats_of_uses_ref_encoder(rng, params):
    """An int8 engine keeps no bf16 executor, yet takes single-image style
    statistics through the ``ref`` encoder, as the JAX engine does."""
    image = torch.from_numpy(rng.random((1, 32, 32, 3), np.float32))
    ref = StylizeEngine(*params, dtype=torch.bfloat16, device="cpu").style_stats_of(image)
    e = StylizeEngine(*params, dtype=torch.bfloat16, device="cpu", engine="int8-fused")
    assert e.enc is None and e.dec is None
    for a, b in zip(e.style_stats_of(image), ref):
        assert torch.equal(a, b)


def _int8_case(rng, params, size):
    enc, dec = params[0], _spread(params[1])
    images = rng.random((2, size, size, 3), np.float32)
    s_means, s_stds = _banks(rng, 2)
    return enc, dec, images, s_means, s_stds


def test_int8_static_matches_jax_engine(rng, params):
    """The same scales dict (the JAX engine's calibration) in both engines."""
    enc, dec, images, s_means, s_stds = _int8_case(rng, params, 32)
    jax_engine = JaxEngine(enc, dec, dtype=jnp.bfloat16, engine="int8-static")
    ref = np.asarray(jax_engine.stylize_multi(jnp.asarray(images), s_means, s_stds, 1.0))
    ours = StylizeEngine(enc, dec, dtype=torch.bfloat16, device="cpu", engine="int8-static",
                         scales=jax_engine.scales)
    got = ours.stylize_multi(torch.from_numpy(images), s_means, s_stds, 1.0)
    assert got.shape == (2, 2, 32, 32, 3) and bool(got.isfinite().all())
    assert ref.max() - ref.min() >= 0.5, (ref.min(), ref.max())
    mae = float(np.mean(np.abs(got.numpy() - ref)))
    assert mae <= 1e-3, mae


@pytest.mark.parametrize("size", [32, 36])
def test_int8_fused_equals_int8_static(rng, params, size, monkeypatch):
    """Self-calibrated on the first batch, as the engines do without scales;
    36 px gives odd pool sizes (18 -> 9 -> 5) in the int8 encoder.
    ``int8-fused`` goes through both fused level-1 stages (K1 once a batch,
    K2 once a style), ``int8-static`` through neither."""
    from ccst_tpu_torch.models import vgg_fast

    calls = {"K1": 0, "K2": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(vgg_fast, "encoder_level1", counted("K1", vgg_fast.encoder_level1))
    monkeypatch.setattr(vgg_fast, "decoder_level1", counted("K2", vgg_fast.decoder_level1))
    enc, dec, images, s_means, s_stds = _int8_case(rng, params, size)
    outs = {}
    for engine, expect in (("int8-static", {"K1": 0, "K2": 0}), ("int8-fused", {"K1": 1, "K2": 2})):
        e = StylizeEngine(enc, dec, dtype=torch.bfloat16, device="cpu", engine=engine)
        calls.update(K1=0, K2=0)
        outs[engine] = e.stylize_multi(torch.from_numpy(images), s_means, s_stds, 1.0)
        assert calls == expect, (engine, calls)
        assert e.scales is not None and not e._needs_calibration
    out = -(-size // 8) * 8  # ceil-mode pools: 36 px decodes to 40 px, as in ccst_tpu
    assert outs["int8-static"].shape == (2, 2, out, out, 3)
    assert torch.equal(outs["int8-static"], outs["int8-fused"])


@pytest.mark.parametrize("engine,dtype", [("packed", "float32"), ("packed", "bfloat16"),
                                          ("int8", "float32"), ("int8", "bfloat16")])
def test_fast_engines_match_jax_engines(rng, params, engine, dtype):
    """``packed`` and the dynamic ``int8`` engine: ``stylize_multi`` against
    ccst_tpu's engine of the same name and dtype, on outputs that spread."""
    enc, dec = params[0], _spread(params[1])
    images = rng.random((2, 32, 32, 3), np.float32)
    s_means, s_stds = _banks(rng, 2)
    ref = np.asarray(JaxEngine(enc, dec, dtype=getattr(jnp, dtype), engine=engine).stylize_multi(
        jnp.asarray(images), s_means, s_stds, 0.8))
    got = StylizeEngine(enc, dec, dtype=getattr(torch, dtype), device="cpu", engine=engine
                        ).stylize_multi(torch.from_numpy(images), s_means, s_stds, 0.8)
    assert got.shape == ref.shape == (2, 2, 32, 32, 3) and got.dtype == torch.float32
    assert ref.max() - ref.min() >= 0.5, (ref.min(), ref.max())
    if (engine, dtype) == ("packed", "float32"):
        np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)
    mae = float(np.mean(np.abs(got.numpy() - ref)))
    assert mae <= 1e-3, mae


def test_packed_float32_equals_ref_float32(rng, params):
    """The packed engine computes what ``ref`` computes: atol 5e-5 in float32,
    with the level-1 stage as edge-padded convs on the packed plane (two in
    the encoder, two a style in the decoder) and every other conv as in ``ref``."""
    from ccst_tpu_torch.models import vgg_fast

    enc, dec = params[0], _spread(params[1])
    images = torch.from_numpy(rng.random((2, 32, 32, 3), np.float32))
    s_means, s_stds = _banks(rng, 3)
    want = StylizeEngine(enc, dec, dtype=torch.float32, device="cpu").stylize_multi(
        images, s_means, s_stds, 1.0)
    pads = []
    conv = vgg_fast.reflect_conv3x3

    def spy(x, cw, relu=True, pad_mode="reflect"):
        pads.append(pad_mode)
        return conv(x, cw, relu, pad_mode)

    engine = StylizeEngine(enc, dec, dtype=torch.float32, device="cpu", engine="packed")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vgg_fast, "reflect_conv3x3", spy)
        got = engine.stylize_multi(images, s_means, s_stds, 1.0)
    assert pads == ["edge"] * 2 + ["reflect"] * 7 + (["reflect"] * 7 + ["edge"] * 2) * 3
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5)


@pytest.mark.parametrize("src,size", [(64, 12), (512, 96), (12, 40), (33, 7)],
                         ids=["down64to12", "down512to96", "up12to40", "odd33to7"])
def test_resize_bilinear_matches_jax_image_resize(rng, src, size):
    from ccst_tpu.pipeline.stylize import resize_bilinear as jax_resize
    from ccst_tpu_torch.pipeline.stylize import resize_bilinear

    images = rng.random((2, src, src, 3), np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(images), size))
    got = resize_bilinear(torch.from_numpy(images), size)
    assert got.shape == (2, size, size, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("size,u8", [(12, False), (48, True)], ids=["down-f32", "up-u8"])
def test_output_size_matches_jax_engine(rng, params, size, u8):
    """``output_size``: the float32 output resized before the uint8
    quantization, as ccst_tpu's engine does; float32 within the float32 bar,
    uint8 within one level."""
    enc, dec = params[0], _spread(params[1])
    images = rng.random((2, 32, 32, 3), np.float32)
    s_means, s_stds = _banks(rng, 1)
    kw = dict(output_size=size, output_u8=u8)
    ref = np.asarray(JaxEngine(enc, dec, dtype=jnp.float32, **kw).stylize(
        jnp.asarray(images), s_means[0], s_stds[0], 1.0))
    got = StylizeEngine(enc, dec, dtype=torch.float32, device="cpu", **kw).stylize(
        torch.from_numpy(images), s_means[0], s_stds[0], 1.0)
    assert got.shape == ref.shape == (2, size, size, 3)
    if u8:
        assert got.dtype == torch.uint8
        assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("shapes", [((16, 20), (16, 20)), ((24, 12), (9, 31))],
                         ids=["same", "other"])
def test_coral_matches_jax(rng, shapes):
    from ccst_tpu.ops.adain import coral as jax_coral
    from ccst_tpu_torch.ops.adain import coral

    source = rng.random((*shapes[0], 3), np.float32)
    target = (rng.random((*shapes[1], 3)) * 0.5 + 0.2).astype(np.float32)
    ref = np.asarray(jax_coral(jnp.asarray(source), jnp.asarray(target)))
    got = coral(torch.from_numpy(source), torch.from_numpy(target))
    assert got.shape == source.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
