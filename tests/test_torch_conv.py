"""The reflect-pad 3x3 conv kernel's plain version and weight layout
(ccst_tpu_torch.kernels.conv), held against ccst_tpu's Pallas conv in
interpret mode and its XLA pad + conv.

Tolerance: rtol=1e-4, atol=1e-5 in float32, as tests/test_kernels.py holds the
Pallas kernel to XLA (same products, sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.kernels.conv_pallas import reflect_conv3x3_fused
from ccst_tpu_torch.kernels.conv import (
    TILE_K,
    TILE_N,
    pack_weight,
    prepare_conv,
    reflect_conv3x3,
    reflect_conv3x3_reference,
)

TOL = dict(rtol=1e-4, atol=1e-5)

# (n, h, w, cin, cout, Pallas row tile): the shapes of tests/test_kernels.py
# plus the Cin = 3 (conv1_1) and Cout = 3 (dconv1_1) edges
SHAPES = [
    (2, 16, 16, 8, 16, 4),
    (1, 12, 20, 4, 8, 6),
    (1, 8, 8, 8, 8, 4),
    (1, 24, 8, 4, 4, 8),
    (1, 8, 12, 3, 64, 4),
    (1, 8, 8, 64, 3, 4),
]


def _operands(rng, n, h, w, cin, cout):
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wk = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, wk, b


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("relu", [True, False])
def test_reference_matches_pallas_conv(rng, shape, relu):
    n, h, w, cin, cout, th = shape
    x, wk, b = _operands(rng, n, h, w, cin, cout)
    ref = reflect_conv3x3_fused(
        jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b), relu=relu, tile_rows=th,
        interpret=True,
    )
    got = reflect_conv3x3_reference(
        torch.from_numpy(x), torch.from_numpy(wk), torch.from_numpy(b), relu
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_reference_rounds_once_to_bfloat16(rng):
    """bf16 operands upcast, f32 sums, one rounding: equal to rounding the
    f32 result of the same bf16 values."""
    x, wk, b = _operands(rng, 1, 6, 5, 8, 8)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(wk).bfloat16()
    got = reflect_conv3x3_reference(xb, wb, torch.from_numpy(b))
    want = reflect_conv3x3_reference(xb.float(), wb.float(), torch.from_numpy(b)).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 3), (256, 512)])
def test_packed_weight_layout(rng, cin, cout):
    wk = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(np.float32))
    packed = pack_weight(wk)
    kp, np_ = packed.shape
    assert kp % TILE_K == 0 and np_ % TILE_N == 0
    assert kp >= 9 * cin and np_ >= cout
    # rows are HWIO's (dy, dx, ci) in order; the padding is zero
    assert torch.equal(packed[: 9 * cin, :cout].reshape(3, 3, cin, cout), wk)
    assert packed[9 * cin :].abs().sum() == 0 and packed[:, cout:].abs().sum() == 0


def test_prepare_conv_rounds_bias_through_dtype(rng):
    x, wk, b = _operands(rng, 1, 4, 4, 8, 8)
    cw = prepare_conv(wk, b, torch.bfloat16, "cpu")
    assert cw.w.dtype == torch.bfloat16 and cw.b.dtype == torch.float32
    assert torch.equal(cw.b, torch.from_numpy(b).bfloat16().float())
    assert prepare_conv(wk[:1, :1], b, torch.float32, "cpu").packed is None  # 1x1


def test_wrapper_on_cpu_is_the_plain_version(rng):
    x, wk, b = _operands(rng, 2, 7, 9, 3, 8)  # odd sizes: no tiling rule
    cw = prepare_conv(wk, b, torch.float32, "cpu")
    before = reflect_conv3x3.launches
    got = reflect_conv3x3(torch.from_numpy(x), cw, relu=True)
    assert torch.equal(got, reflect_conv3x3_reference(torch.from_numpy(x), cw.w, cw.b, True))
    assert reflect_conv3x3.launches == before


# A meta tensor carries shape and dtype without a card: the checks the CUDA
# path makes before it builds or launches anything run on it here.
def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "x,error",
    [
        (_meta((1, 1, 4, 64)), ValueError),                         # H < 2
        (_meta((1, 4, 4, 32)), ValueError),                         # Cin mismatch
        (_meta((1, 4, 4, 64), torch.float32), TypeError),           # bf16 only
        (_meta((1, 4, 64, 4)).permute(0, 1, 3, 2), ValueError),     # not contiguous
    ],
    ids=["h1", "cin", "f32", "strided"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(x, error):
    cw = prepare_conv(torch.randn(3, 3, 64, 8), torch.randn(8), torch.bfloat16, "meta")
    before = reflect_conv3x3.launches
    with pytest.raises(error):
        reflect_conv3x3(x, cw)
    assert reflect_conv3x3.launches == before


def test_build_is_keyed_by_the_sources(tmp_path, monkeypatch):
    from ccst_tpu_torch.kernels import _build

    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    src.write_text("// b\n")
    assert _build.library_path() != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    from ccst_tpu_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
