"""Row-sharded stylize (``ccst_tpu_torch/parallel/spatial.py``) against
``ccst_tpu/parallel/spatial.py``, and K4's given-statistics entry.

One module fixture spawns four gloo ranks of ``tests/torch_multihost_worker.py
spatial`` on the CPU (the kernels' plain versions, one thread a rank), which
run, each output gathered on every rank:

- the float32 ``ref`` stylize over 4 ranks on ``ccst_tpu``'s inputs of
  ``tests/test_parallel.py::test_spatial_sharded_stylize_matches_single_device``
  ((1, 128, 64, 3), full VGG widths): against ``ccst_tpu``'s
  ``make_spatial_stylize`` on a 4-device CPU mesh at its bar, rtol 1e-4,
  atol 1e-5;
- the int8-static stylize over 2 ranks at (1, 32, 32, 3) (2 relu4_1 rows a
  rank) from ``ccst_tpu``'s calibration: against ``ccst_tpu``'s
  ``make_spatial_stylize_q8s`` on a 2-device mesh at its bar, atol 5e-4, and
  against the port's own single-rank int8-static path at the same bar;
- the batch int8-static stylize over 4 ranks of one image each: bit-equal to
  the port's single-rank path on the whole batch;
- ``whole_plane_stats`` of two ranks' halves of a feature plane (K5's plain
  version, ``welford_psum``), which K4's given-statistics entry then takes.

The ranks' outputs are the same bits on every rank.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.models import convert as jconvert
from ccst_tpu.models import vgg as jvgg
from ccst_tpu.models import vgg_fast as jfast
from ccst_tpu.parallel import spatial as jspatial
from ccst_tpu.pipeline.stylize import StylizeEngine as JEngine
from ccst_tpu_torch.kernels.adain import (fused_adain_given, fused_adain_multi,
                                          fused_adain_reference)
from ccst_tpu_torch.models import vgg_fast
from ccst_tpu_torch.models.convert import load_decoder, load_encoder
from ccst_tpu_torch.parallel import spatial
from tests.test_torch_multihost import _ranks
from tests.torch_parity import one_torch_thread  # noqa: F401


def _stats(rng, c=512):
    mean = rng.standard_normal(c).astype(np.float32) * 0.05
    return mean, (rng.random(c).astype(np.float32) * 0.1 + 0.05).astype(np.float32)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(the ranks' results, the inputs, the JAX parameters, the JAX scales)."""
    work = str(tmp_path_factory.mktemp("spatial"))
    enc = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(0), jvgg.ENCODER_ARCH))
    dec = jax.tree.map(np.asarray, jvgg.init_params(jax.random.PRNGKey(1), jvgg.DECODER_ARCH))
    jconvert.save_npz(os.path.join(work, "enc.npz"), enc)
    jconvert.save_npz(os.path.join(work, "dec.npz"), dec)
    rng = np.random.default_rng(0)
    images = rng.random((1, 128, 64, 3), dtype=np.float32)
    s_mean, s_std = _stats(rng)
    images8 = rng.random((1, 32, 32, 3)).astype(np.float32)
    s8_mean, s8_std = _stats(rng)
    inputs = dict(images=images, s_mean=s_mean, s_std=s_std, images8=images8, s8_mean=s8_mean,
                  s8_std=s8_std, batch=rng.random((4, 32, 32, 3)).astype(np.float32),
                  plane=(rng.random((1, 16, 8, 512)) * 3.0 + 2.0).astype(np.float32))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    scales = {k: float(v) for k, v in jfast.calibrate_scales(
        enc, dec, jnp.asarray(images8), [(s8_mean, s8_std)]).items()}
    ranks = _ranks("spatial", 4, os.path.join(work, "ranks"),
                   dict(inputs=os.path.join(work, "inputs.npz"), scales=scales,
                        enc=os.path.join(work, "enc.npz"), dec=os.path.join(work, "dec.npz")))
    return ranks, inputs, (enc, dec), scales, work


def test_float32_over_four_ranks_matches_jax(sharded):
    ranks, inp, (enc, dec), _, _ = sharded
    assert all(torch.equal(r["f32"], ranks[0]["f32"]) for r in ranks)
    want = np.asarray(jspatial.make_spatial_stylize(jspatial.make_spatial_mesh(4), jnp.float32)(
        enc, dec, inp["images"], inp["s_mean"], inp["s_std"], 1.0))
    got = ranks[0]["f32"].numpy()
    assert got.shape == (1, 128, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # and the single device of ccst_tpu's engine, the bar of ccst_tpu's own test
    single = np.asarray(JEngine(enc, dec, dtype=jnp.float32).stylize(
        jnp.asarray(inp["images"]), inp["s_mean"], inp["s_std"], 1.0))
    np.testing.assert_allclose(got, single, rtol=1e-4, atol=1e-5)


def _port_q8s(work, scales):
    enc, dec = load_encoder(os.path.join(work, "enc.npz")), load_decoder(
        os.path.join(work, "dec.npz"))
    return (vgg_fast.prepare_encoder_q8s(vgg_fast.cast_params(enc, torch.float32), scales,
                                         torch.bfloat16, "cpu"),
            vgg_fast.prepare_decoder_q8s(vgg_fast.cast_params(dec, torch.float32), scales,
                                         torch.bfloat16, "cpu"))


def _single_q8s(eq, dq, images, s_mean, s_std):
    with torch.no_grad():
        feat = vgg_fast.apply_encoder_q8s(eq, torch.from_numpy(images))
        t = fused_adain_multi(feat, torch.from_numpy(s_mean)[None], torch.from_numpy(s_std)[None])
        return vgg_fast.apply_decoder_q8s(dq, t[0]).float()


def test_int8_static_over_two_ranks_matches_jax(sharded):
    ranks, inp, (enc, dec), scales, work = sharded
    assert torch.equal(ranks[0]["q8"], ranks[1]["q8"])
    assert "q8" not in ranks[2] and "q8" not in ranks[3]
    jscales = {k: jnp.float32(v) for k, v in scales.items()}
    run = jspatial.make_spatial_stylize_q8s(jspatial.make_spatial_mesh(2),
                                            jfast.prepare_encoder_q8s(enc, jscales),
                                            jfast.prepare_decoder_q8s(dec, jscales))
    want = np.asarray(run(jnp.asarray(inp["images8"]), inp["s8_mean"], inp["s8_std"]))
    got = ranks[0]["q8"].numpy()
    assert got.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=5e-4)
    single = _single_q8s(*_port_q8s(work, scales), inp["images8"], inp["s8_mean"],
                         inp["s8_std"]).numpy()
    np.testing.assert_allclose(got, single, atol=5e-4)


def test_batch_int8_static_is_the_single_rank_bit_for_bit(sharded):
    ranks, inp, _, scales, work = sharded
    assert all(torch.equal(r["batch"], ranks[0]["batch"]) for r in ranks)
    want = _single_q8s(*_port_q8s(work, scales), inp["batch"], inp["s8_mean"], inp["s8_std"])
    assert ranks[0]["batch"].shape == (4, 32, 32, 3)
    assert torch.equal(ranks[0]["batch"], want)


def _plain_stats(x):
    """fused_adain_reference's own statistics of a float32 plane."""
    mean = x.mean(dim=(1, 2))
    var = torch.square(x - mean[:, None, None]).sum(dim=(1, 2)) / (x.shape[1] * x.shape[2] - 1)
    return mean, torch.rsqrt(var + 1e-5)


def test_given_statistics_plain_path(sharded):
    ranks, inp, _, _, _ = sharded
    plane = torch.from_numpy(inp["plane"])
    s_means, s_stds = (torch.from_numpy(np.stack(v)) for v in zip(*[
        _stats(np.random.default_rng(s)) for s in range(3)]))
    mean, inv = _plain_stats(plane)
    for alpha in (1.0, 0.6):
        want = torch.stack([fused_adain_reference(plane, m, s, alpha)
                            for m, s in zip(s_means, s_stds)])
        assert torch.equal(fused_adain_given(plane, mean, inv, s_means, s_stds, alpha), want)
    # the two ranks' merged statistics: the same bits on both, the whole
    # plane's within float32's reduction error, and the restyled plane with it
    (m0, i0), (m1, i1) = ranks[0]["stats"], ranks[1]["stats"]
    assert torch.equal(m0, m1) and torch.equal(i0, i1)
    np.testing.assert_allclose(m0.numpy(), mean.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(i0.numpy(), inv.numpy(), rtol=1e-5)
    np.testing.assert_allclose(fused_adain_given(plane, m0, i0, s_means, s_stds).numpy(),
                               fused_adain_multi(plane, s_means, s_stds).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("height,ranks", [(100, 1), (128, 3), (64, 8), (8, 1), (32, 4)])
def test_shard_geometry_that_breaks_the_rule_raises(height, ranks):
    with pytest.raises(ValueError, match="relu4_1"):
        spatial.check_geometry(height, ranks)
    if ranks == 1:  # the entry point itself, on a single process
        with pytest.raises(ValueError, match="relu4_1"):
            spatial.make_spatial_stylize(None, torch.float32, "cpu")(
                {}, {}, torch.zeros((1, height, 16, 3)), np.zeros(512), np.ones(512))
    assert spatial.check_geometry(16 * ranks, ranks) == 16


def test_batch_that_does_not_split_raises(sharded, monkeypatch):
    _, _, _, scales, work = sharded
    run = spatial.make_batch_stylize_q8s(None, *_port_q8s(work, scales))
    monkeypatch.setattr(spatial, "_size", lambda group: 3)  # three ranks, no process group
    with pytest.raises(ValueError, match="not divisible"):
        run(torch.zeros((4, 32, 32, 3)), np.zeros(512), np.ones(512))
