"""K3 with a nearest-2x upsample folded into its halo gather
(``reflect_conv3x3(..., upsample=True)``, ``ConvGeom::up``): the numpy models
of the two stage kernels' addressing through the up map, the wrapper's plain
version, and the decoders' walk, each held to the composition of
``upsample_nearest2x`` and the conv.
"""
import numpy as np
import pytest
import torch

from ccst_tpu_torch.kernels import conv as tconv
from ccst_tpu_torch.kernels import igemm_layout
from ccst_tpu_torch.kernels.conv import (
    pack_f32_stages,
    pack_weight,
    prepare_conv,
    reflect_conv3x3,
    reflect_conv3x3_reference,
    simulate_f32_conv,
    upsample_nearest2x,
)
from ccst_tpu_torch.models import vgg

PAD_MODES = ["reflect", "edge"]

# source planes (n, h, w, cin, cout): ragged and odd (37 x 53 upsamples to
# 74 x 106, no multiple of the 8 x 16 tile), one pixel (a 2 x 2 output, the
# smallest reflectable plane), one row, Cin ending inside a chunk, Cout = 3
# (the narrow tile) and two 128-wide tiles
UP_SHAPES = [(1, 37, 53, 16, 24), (2, 5, 3, 24, 3), (1, 1, 1, 64, 64), (1, 1, 9, 8, 16),
             (1, 4, 9, 80, 130)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("pad_mode", PAD_MODES)
@pytest.mark.parametrize("shape", UP_SHAPES, ids=_ids(UP_SHAPES))
def test_wgmma_addressing_through_the_up_map_equals_the_composition(rng, shape, pad_mode):
    """The core's halo gather at ``pad_index(i, 2H) >> 1`` (``row_shift`` 0),
    walked in numpy as the kernel walks it, gives the sums of upsampling
    first and convolving the upsampled plane, exactly (small integers: float64
    adds no rounding)."""
    n, h, w, cin, cout = shape
    x = rng.integers(-4, 5, (n, h, w, cin)).astype(np.float64)
    wk = torch.from_numpy(rng.integers(-4, 5, (3, 3, cin, cout)).astype(np.float32)).bfloat16()
    got = igemm_layout.simulate_conv(x, pack_weight(wk).double().numpy(), cout,
                                     reflect=pad_mode == "reflect", row_shift=0, up=True)
    want = reflect_conv3x3_reference(upsample_nearest2x(torch.from_numpy(x)), wk.double(),
                                     torch.zeros(cout), relu=False, pad_mode=pad_mode)
    assert got.shape == (n, 2 * h, 2 * w, cout)
    np.testing.assert_array_equal(got, want.numpy())


# float32 stage kernel: Cin 4 / 12 / 68 (chunks of 4 and 8, one half past
# Cin), Cout 3 / 7 / 64 / 130 (tiles 4, 8, 64, 128), odd source planes
F32_UP_SHAPES = [(1, 5, 9, 12, 7), (2, 3, 2, 4, 3), (1, 9, 5, 68, 130), (1, 1, 3, 12, 64)]


@pytest.mark.parametrize("pad_mode", PAD_MODES)
@pytest.mark.parametrize("shape", F32_UP_SHAPES, ids=_ids(F32_UP_SHAPES))
def test_f32_addressing_through_the_up_map_equals_the_composition(rng, shape, pad_mode):
    """The float32 stage kernel's model with ``Geom::up``: the composition's
    sums within 1e-5 (the model sums in float64, the plain version in
    float32), as the unfolded model is held."""
    n, h, w, cin, cout = shape
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wk = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32))
    got = simulate_f32_conv(x.astype(np.float64), pack_f32_stages(wk).double().numpy(), cout,
                            reflect=pad_mode == "reflect", up=True)
    want = reflect_conv3x3_reference(upsample_nearest2x(torch.from_numpy(x)), wk,
                                     torch.zeros(cout), relu=False, pad_mode=pad_mode)
    assert got.shape == (n, 2 * h, 2 * w, cout)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("pad_mode", PAD_MODES)
@pytest.mark.parametrize("relu", [True, False])
def test_wrapper_on_cpu_is_the_composition_bit_for_bit(rng, dtype, pad_mode, relu):
    x = torch.from_numpy(rng.standard_normal((2, 7, 5, 16)).astype(np.float32)).to(dtype)
    cw = prepare_conv(rng.standard_normal((3, 3, 16, 24)).astype(np.float32) * 0.1,
                      rng.standard_normal(24).astype(np.float32), dtype, "cpu")
    before = reflect_conv3x3.launches, reflect_conv3x3.up_launches
    got = reflect_conv3x3(x, cw, relu, pad_mode, upsample=True)
    want = reflect_conv3x3(upsample_nearest2x(x), cw, relu, pad_mode)
    assert got.shape == (2, 14, 10, 24) and got.dtype == dtype
    assert torch.equal(got, want)
    assert (reflect_conv3x3.launches, reflect_conv3x3.up_launches) == before


def _unfused(params, x, arch):
    """The walk with every upsample written out, as before the fold."""
    for layer in arch:
        if isinstance(layer, vgg.Conv):
            cw = params[layer.name]
            x = reflect_conv3x3_reference(x, cw.w, cw.b, layer.relu)
        elif isinstance(layer, vgg.Upsample):
            x = upsample_nearest2x(x)
    return x


def _watch(monkeypatch):
    """Record the ``upsample`` flag of every conv the walk launches, and fail
    on any upsample it materialises."""
    seen = []
    real = vgg.reflect_conv3x3

    def conv(x, cw, relu=True, pad_mode="reflect", upsample=False):
        seen.append(upsample)
        return real(x, cw, relu, pad_mode, upsample)

    def no_upsample(x):
        raise AssertionError("the kernel route materialised an upsample")

    monkeypatch.setattr(vgg, "reflect_conv3x3", conv)
    monkeypatch.setattr(vgg, "upsample_nearest2x", no_upsample)
    return seen


def _prepared(arch, seed):
    return vgg.prepare_params(vgg.init_params(arch, torch.Generator().manual_seed(seed)),
                              torch.bfloat16, "cpu")


def test_apply_decoder_folds_every_upsample_and_keeps_the_bits(monkeypatch):
    dec = _prepared(vgg.DECODER_ARCH, 3)
    feat = torch.rand((2, 3, 2, 512), generator=torch.Generator().manual_seed(4)).bfloat16()
    want = _unfused(dec, feat, vgg.DECODER_ARCH)
    seen = _watch(monkeypatch)
    got = vgg.apply_decoder(dec, feat)
    assert got.shape == (2, 24, 16, 3) and torch.equal(got, want)
    # dconv3_4, dconv2_2 and dconv1_2 gather through the up map
    assert seen == [False, True, False, False, False, True, False, True, False]


@pytest.mark.parametrize("level,ups", [("relu5_1", 4), ("relu4_1", 3), ("relu3_1", 2),
                                       ("relu2_1", 1), ("relu1_1", 0)])
def test_each_wct_decoder_folds_its_upsamples_and_keeps_the_bits(monkeypatch, level, ups):
    arch = vgg.WCT_DECODER_ARCHS[level]
    dec = _prepared(arch, 5)
    cin = next(layer for layer in arch if isinstance(layer, vgg.Conv)).cin
    feat = torch.rand((1, 2, 3, cin), generator=torch.Generator().manual_seed(6)).bfloat16()
    want = _unfused(dec, feat, arch)
    seen = _watch(monkeypatch)
    got = vgg.decode_from(dec, feat, level)
    assert got.shape == (1, 2 << ups, 3 << ups, 3) and torch.equal(got, want)
    assert sum(seen) == ups and len(seen) == sum(isinstance(layer, vgg.Conv) for layer in arch)


def test_the_autograd_route_keeps_its_upsamples(monkeypatch):
    """Training walks through F.conv2d and materialises each upsample: the
    fold is the kernel route's alone."""
    calls = []
    real = vgg.upsample_nearest2x
    monkeypatch.setattr(vgg, "upsample_nearest2x", lambda x: calls.append(x.shape) or real(x))
    dec = vgg.trainable_params(vgg.init_params(vgg.DECODER_ARCH, torch.Generator().manual_seed(7)),
                               "cpu", requires_grad=False)
    out = vgg.apply_decoder(dec, torch.rand((1, 2, 2, 512)), route="autograd")
    assert out.shape == (1, 16, 16, 3) and len(calls) == 3


def test_an_upsample_before_anything_but_a_3x3_conv_is_materialised(monkeypatch):
    """The walk folds only where the spec puts a 3x3 conv right after the
    upsample; before a tap, a 1x1 conv or at the end it upsamples."""
    arch = (vgg.Upsample(), vgg.Tap("t"), vgg.Conv("a", 8, 8), vgg.Upsample(),
            vgg.Conv("b", 8, 8, ksize=1), vgg.Upsample())
    params = _prepared(arch, 8)
    x = torch.rand((1, 2, 3, 8)).bfloat16()
    seen = []
    real = vgg.upsample_nearest2x
    monkeypatch.setattr(vgg, "upsample_nearest2x", lambda t: seen.append(t.shape) or real(t))
    out, taps = vgg._apply(params, x, arch, taps=("t",))
    assert len(seen) == 3 and out.shape == (1, 16, 24, 8) and taps["t"].shape == (1, 4, 6, 8)


# A meta tensor carries shape and dtype without a card: the checks the CUDA
# path makes before it builds or launches anything run on it here.
def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "x,error",
    [
        (_meta((1, 0, 4, 64)), ValueError),                         # an empty plane
        (_meta((1, 4, 4, 32)), ValueError),                         # Cin mismatch
        (_meta((1, 4, 4, 64), torch.float16), TypeError),           # float16
        (_meta((1, 4, 64, 4)).permute(0, 1, 3, 2), ValueError),     # not contiguous
    ],
    ids=["h0", "cin", "f16", "strided"],
)
def test_wrapper_rejects_what_the_folded_kernel_does_not_take(x, error):
    cw = prepare_conv(torch.randn(3, 3, 64, 8), torch.randn(8), torch.bfloat16, "meta")
    before = reflect_conv3x3.launches, reflect_conv3x3.up_launches
    with pytest.raises(error):
        reflect_conv3x3(x, cw, upsample=True)
    assert (reflect_conv3x3.launches, reflect_conv3x3.up_launches) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("cin,folds", [(3, False), (16, True), (64, True)])
def test_folded_or_composed_launch_reaches_the_build(monkeypatch, dtype, cin, folds):
    """The stage routes take the source plane as it is, one pixel high
    included (its upsampled plane is 2 rows, enough to reflect); the
    scalar-gather route (Cin = 3) upsamples first and convolves that."""
    from ccst_tpu_torch.kernels import _build

    class Reached(Exception):
        pass

    def library():
        raise Reached

    composed = []
    real = tconv.upsample_nearest2x
    monkeypatch.setattr(_build, "library", library)
    monkeypatch.setattr(tconv, "upsample_nearest2x", lambda t: composed.append(t.shape) or real(t))
    cw = prepare_conv(torch.randn(3, 3, cin, 8), torch.randn(8), dtype, "meta")
    with pytest.raises(Reached):
        reflect_conv3x3(_meta((2, 1, 7, cin), dtype), cw, upsample=True)
    assert composed == ([] if folds else [(2, 1, 7, cin)])
