"""K0's plain version (ccst_tpu_torch.kernels.qconv) held against
ccst_tpu.models.vgg_fast._qconv_s, bit for bit: the same int8 inputs, int8
weights and float32 epilogue terms, made from a seed with numpy.

On the CPU the wrapper runs the plain version; the CUDA kernel is held to the
same plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.models import vgg_fast as jf
from ccst_tpu_torch.kernels import igemm_layout, qconv


def _layer(rng, cin, cout, requant, packed=False):
    """Random int8 weights and epilogue terms that put y over about +-100."""
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    acc_std = 127 * 73 * np.sqrt(9 * cin)
    k = (rng.uniform(0.5, 1.5, cout) * 40 / acc_std).astype(np.float32)
    kb = (rng.standard_normal(cout) * 10).astype(np.float32)
    theirs = jf.QConvS(jnp.asarray(wq), jnp.asarray(k), jnp.asarray(kb), packed, requant)
    ours = qconv.make_qconv(wq, k, kb, packed, requant, "cpu")
    return theirs, ours


CASES = [
    # (N, H, W, Cin, Cout), pad, requant, relu, out dtype
    ((2, 9, 7, 64, 128), "reflect", True, True, "int8"),     # odd plane, conv2_1
    ((2, 9, 7, 64, 128), "reflect", True, False, "int8"),    # clip at -127
    ((1, 6, 6, 128, 64), "edge", True, True, "int8"),
    ((2, 4, 4, 256, 512), "reflect", False, True, "bfloat16"),  # conv4_1 dequant + ReLU
    ((1, 5, 3, 128, 64), "reflect", False, False, "float32"),
    ((2, 8, 8, 12, 256), "edge", True, True, "int8"),        # packed conv1_1 (K = 108)
    ((1, 8, 6, 64, 256), "edge", True, True, "int8"),        # folded dconv1_2
    ((2, 8, 8, 256, 12), "edge", False, False, "bfloat16"),  # packed dconv1_1 (Cout = 12)
    ((1, 1, 5, 12, 256), "edge", True, True, "int8"),        # one row
]


@pytest.mark.parametrize("shape,pad,requant,relu,out", CASES)
def test_plain_version_matches_qconv_s(rng, shape, pad, requant, relu, out):
    n, h, w, cin, cout = shape
    theirs, ours = _layer(rng, cin, cout, requant, packed=cin == 12 or cout == 12)
    x = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    ref = np.asarray(jf._qconv_s(jnp.asarray(x), theirs, relu, getattr(jnp, out), pad))
    got = qconv.qconv3x3_s8(torch.from_numpy(x), ours, relu, getattr(torch, out), pad)
    assert got.shape == (n, h, w, cout)
    assert got.dtype == (torch.int8 if requant else getattr(torch, out))
    if requant:
        assert got.numpy().min() >= (0 if relu else -127)
        assert len(np.unique(got.numpy())) > 20  # the outputs do spread
    np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))


def test_gemm_weight_layout(rng):
    """Row n of the kernel's matrix is output channel n in (dy, dx, ci)
    order; the padding to the 64 x 64 tiles is zero."""
    wq = rng.integers(-127, 128, (3, 3, 12, 20)).astype(np.int8)
    wt = qconv.gemm_weight(wq)
    assert wt.shape == (64, 128) and wt.dtype == np.int8
    np.testing.assert_array_equal(wt[:20, :108], wq.reshape(108, 20).T)
    assert not wt[20:].any() and not wt[:, 108:].any()
    assert wt[5, (2 * 3 + 1) * 12 + 7] == wq[2, 1, 7, 5]


@pytest.mark.parametrize("cin,cout", [(12, 256), (256, 12), (64, 128), (512, 256)])
def test_packed_weight_layout(rng, cin, cout):
    """K0's own layout: the gather path's matrix for Cin = 12, else the stage
    tiles (n tiles, 128-channel chunks, taps, 16-byte groups, BN, 16), which
    round-trip to HWIO and pad with zeros. The matrix is built only where it
    is used: no other field carries it."""
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    q = qconv.make_qconv(wq, np.ones(cout, np.float32), np.zeros(cout, np.float32),
                         False, True, "cpu")
    assert not hasattr(q, "wt")
    if cin % 16:
        np.testing.assert_array_equal(q.wp.numpy(), qconv.gemm_weight(wq))
        return
    bn = igemm_layout.pick_bn(cout, qconv.NARROW_N)
    assert bn == (qconv.NARROW_N if cout == 12 else 128)
    assert q.wp.shape == (-(-cout // bn), -(-cin // 128), 9, 8, bn, 16) and q.wp.is_contiguous()
    np.testing.assert_array_equal(igemm_layout.unpack_stage_tiles(q.wp, cin, cout).numpy(), wq)
    assert q.wp[0, 0, 7, 3, 2, 9] == wq[2, 1, 3 * 16 + 9, 2]
    assert np.abs(q.wp.numpy().astype(np.int64)).sum() == np.abs(wq.astype(np.int64)).sum()


# ragged shapes for the model of the kernel's addressing: odd planes, a plane
# smaller than the tile, one row (edge only), Cin = 64 (half a chunk) and 144
# (ending inside the second), Cout = 12 (narrow tile), 100 (128-wide), 130 (two
# tiles) and 264 (three)
MODEL_CASES = [
    ((2, 9, 17, 144, 12), "edge"),
    ((1, 5, 33, 64, 130), "reflect"),
    ((1, 3, 4, 32, 100), "reflect"),
    ((1, 2, 3, 16, 264), "edge"),
    ((1, 1, 5, 16, 16), "edge"),
    ((2, 2, 2, 128, 64), "reflect"),
]


@pytest.mark.parametrize("shape,pad", MODEL_CASES)
def test_kernel_addressing_model_equals_plain_version(rng, shape, pad):
    """The halo gather by reflected or clamped index, the planes, the tap
    offsets and the packed weight runs, walked in numpy as the kernel walks
    them, give the plain version's int32 sums exactly."""
    n, h, w, cin, cout = shape
    x = rng.integers(-127, 128, (n, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    got = igemm_layout.simulate_conv(x.astype(np.int64), qconv.pack_weight(wq).astype(np.int64),
                                     cout, reflect=pad == "reflect")
    want = qconv.qconv3x3_s8_reference(
        torch.from_numpy(x), torch.from_numpy(wq), torch.ones(cout), torch.zeros(cout),
        False, False, torch.float32, pad)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))


def test_rejects_unknown_pad_mode(rng):
    _, ours = _layer(rng, 64, 64, True)
    with pytest.raises(ValueError, match="pad_mode"):
        qconv.qconv3x3_s8(torch.zeros((1, 4, 4, 64), dtype=torch.int8), ours, True,
                          torch.bfloat16, "zero")


# A meta tensor carries shape and dtype without a card: the checks the CUDA
# path makes before it builds or launches anything run on it here.
def _meta(shape, dtype=torch.int8):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "x,pad,error",
    [
        (_meta((1, 4, 4, 32)), "reflect", ValueError),                   # Cin mismatch
        (_meta((1, 1, 4, 64)), "reflect", ValueError),                   # H < 2 for reflect
        (_meta((1, 4, 4, 64), torch.bfloat16), "edge", TypeError),       # int8 only
        (_meta((1, 4, 64, 4)).permute(0, 1, 3, 2), "edge", ValueError),  # not contiguous
        (_meta((1, 4, 1, 64)), "reflect", ValueError),                   # W < 2 for reflect
    ],
    ids=["cin", "h1", "bf16", "strided", "w1"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(rng, x, pad, error):
    q = qconv.make_qconv(rng.integers(-127, 128, (3, 3, 64, 8)).astype(np.int8),
                         np.ones(8, np.float32), np.zeros(8, np.float32), False, True, "meta")
    before = qconv.qconv3x3_s8.launches
    with pytest.raises(error):
        qconv.qconv3x3_s8(x, q, True, torch.bfloat16, pad)
    assert qconv.qconv3x3_s8.launches == before


def test_dynamic_multiplier_reaches_the_build(rng, monkeypatch):
    """The dynamic engine's multiplier ``k * a_scale``, formed on the input's
    device from a 0-d float32 scale, passes every operand check and asks for
    the kernel library: the launch needs nothing from the host."""
    from ccst_tpu_torch.kernels import _build

    class Reached(Exception):
        pass

    def library():
        raise Reached

    q = qconv.make_qconv(rng.integers(-127, 128, (3, 3, 64, 8)).astype(np.int8),
                         np.ones(8, np.float32), np.zeros(8, np.float32), False, False, "meta")
    q = q._replace(k=q.k * torch.empty((), dtype=torch.float32, device="meta"))
    monkeypatch.setattr(_build, "library", library)
    with pytest.raises(Reached):
        qconv.qconv3x3_s8(_meta((1, 1, 4, 64)), q, False, torch.float32, "edge")
