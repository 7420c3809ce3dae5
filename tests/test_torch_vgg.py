"""ccst_tpu_torch VGG encoder / decoder and weight conversion, held against
ccst_tpu on the same JAX-initialized weights.

Tolerance: float32 rtol=1e-4, atol=1e-5 (the same convs, sums in another
order); the layout primitives and the weight bridge are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.models import convert as jconvert
from ccst_tpu.models import vgg as jvgg
from ccst_tpu_torch.kernels import conv as tconv
from ccst_tpu_torch.kernels import igemm_layout
from ccst_tpu_torch.models import convert as tconvert
from ccst_tpu_torch.models import vgg as tvgg

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def jax_params():
    enc = jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH)
    dec = jvgg.init_params(jax.random.PRNGKey(43), jvgg.DECODER_ARCH)
    return jax.tree.map(np.asarray, enc), jax.tree.map(np.asarray, dec)


@pytest.mark.parametrize("which", ["ENCODER_ARCH", "DECODER_ARCH"])
def test_arch_specs_equal_jax(which):
    ours, theirs = getattr(tvgg, which), getattr(jvgg, which)
    assert [(type(l).__name__, tuple(l)) for l in ours] == [
        (type(l).__name__, tuple(l)) for l in theirs
    ]


def test_from_jax_params_bridge(jax_params):
    """A ccst_tpu numpy parameter tree goes straight into prepare_params, for
    the float32 route (float32 stage tiles where Cin is a multiple of 4, else
    the gather kernel's matrix) and for bfloat16 (stage tiles where Cin is a
    multiple of 8)."""
    enc_np, _ = jax_params
    for dtype in (torch.float32, torch.bfloat16):
        prepared = tvgg.prepare_params(enc_np, dtype, "cpu")
        assert set(prepared) == set(enc_np)
        for name, p in enc_np.items():
            cw = prepared[name]
            w = torch.from_numpy(np.array(p["w"])).to(dtype)
            assert torch.equal(cw.w, w)
            assert torch.equal(cw.b, torch.from_numpy(np.array(p["b"])).to(dtype).float())
            cin, cout = p["w"].shape[2:]
            if p["w"].shape[0] != 3:
                assert cw.packed is None
            elif dtype == torch.float32 and cin % 4 == 0:  # the float32 stage tiles
                assert torch.equal(tconv.unpack_f32_stages(cw.packed, cin, cout), w)
            elif cin % 8 or dtype == torch.float32:  # the gather paths' (Kp, Np) matrix
                assert cw.packed.dtype == dtype
                assert torch.equal(cw.packed[:9 * cin, :cout], w.reshape(9 * cin, cout))
            else:          # the wgmma path's stage tiles
                assert torch.equal(igemm_layout.unpack_stage_tiles(cw.packed, cin, cout), w)


@pytest.mark.parametrize("shape", [(2, 6, 6, 4), (1, 7, 5, 3)])
def test_layout_primitives_match_jax(rng, shape):
    x = rng.standard_normal(shape, dtype=np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(tvgg.reflect_pad(xt).numpy(), np.asarray(jvgg.reflect_pad(xj)))
    np.testing.assert_array_equal(tvgg.maxpool_ceil(xt).numpy(), np.asarray(jvgg.maxpool_ceil(xj)))
    np.testing.assert_array_equal(
        tvgg.upsample_nearest2x(xt).numpy(), np.asarray(jvgg.upsample_nearest2x(xj))
    )


def test_init_params_shapes_and_bounds():
    params = tvgg.init_params(tvgg.DECODER_ARCH, torch.Generator().manual_seed(0))
    for layer in tvgg.DECODER_ARCH:
        if isinstance(layer, tvgg.Conv):
            w, b = params[layer.name]["w"], params[layer.name]["b"]
            assert w.shape == (3, 3, layer.cin, layer.cout) and b.shape == (layer.cout,)
            bound = (1.0 / (9 * layer.cin)) ** 0.5
            assert w.abs().max() <= bound and b.abs().max() <= bound


def test_encoder_decoder_match_jax_f32(rng, jax_params):
    enc_np, dec_np = jax_params
    images = rng.random((2, 32, 32, 3), dtype=np.float32)
    feat_j = jvgg.apply_encoder(jax.tree.map(jnp.asarray, enc_np), jnp.asarray(images))
    feat_t = tvgg.apply_encoder(
        tvgg.prepare_params(enc_np, torch.float32, "cpu"), torch.from_numpy(images)
    )
    assert feat_t.shape == (2, 4, 4, 512)
    np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j), **TOL)
    out_j = jvgg.apply_decoder(jax.tree.map(jnp.asarray, dec_np), feat_j)
    out_t = tvgg.apply_decoder(
        tvgg.prepare_params(dec_np, torch.float32, "cpu"), torch.from_numpy(np.array(feat_j))
    )
    assert out_t.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


def test_npz_round_trip_across_packages(tmp_path, jax_params):
    enc_np, _ = jax_params
    jax_file, torch_file = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jconvert.save_npz(jax_file, jax.tree.map(jnp.asarray, enc_np))
    ours = tconvert.load_npz(jax_file)
    tconvert.save_npz(torch_file, ours)
    theirs = jconvert.load_npz(torch_file)
    for name, p in enc_np.items():
        for kind in ("w", "b"):
            np.testing.assert_array_equal(ours[name][kind].numpy(), p[kind])
            np.testing.assert_array_equal(np.asarray(theirs[name][kind]), p[kind])


def test_pth_loading_matches_jax(tmp_path):
    from tests.torch_ref import build_torch_stack

    torch.manual_seed(0)
    stack = build_torch_stack(jvgg.DECODER_ARCH)
    path = str(tmp_path / "decoder.pth")
    torch.save(stack.state_dict(), path)
    ours = tconvert.load_decoder(path)
    theirs = jconvert.load_decoder(path)
    assert set(ours) == set(theirs)
    for name in theirs:
        for kind in ("w", "b"):
            np.testing.assert_array_equal(ours[name][kind].numpy(), np.asarray(theirs[name][kind]))
