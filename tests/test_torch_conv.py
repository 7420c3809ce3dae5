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
from ccst_tpu_torch.kernels import igemm_layout
from ccst_tpu_torch.kernels.conv import (
    NARROW_N,
    TILE_K,
    TILE_N,
    f32_bn,
    f32_tile,
    pack_f32_stages,
    pack_weight,
    prepare_conv,
    reflect_conv3x3,
    reflect_conv3x3_reference,
    simulate_f32_conv,
    unpack_f32_stages,
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


# (n, h, w, cin, cout): the packed engine's four level-1 convs at a small plane
# (conv1_1 with its 16 padded channels, conv1_2, dconv1_2 folded, dconv1_1),
# then one row and one column
EDGE_SHAPES = [(2, 6, 5, 16, 64), (1, 4, 4, 64, 64), (1, 3, 5, 16, 64), (2, 4, 6, 64, 12),
               (1, 1, 7, 8, 16), (1, 5, 1, 8, 16)]


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_edge_mode_matches_xla_edge_pad_conv(rng, shape):
    """``pad_mode="edge"``: jnp.pad(mode="edge") + VALID conv with float32
    sums, as ``ccst_tpu``'s packed_reflect_conv runs it, within the float32
    tolerance; planes of one row or column are fine for edge padding."""
    import jax

    n, h, w, cin, cout = shape
    x, wk, b = _operands(rng, n, h, w, cin, cout)
    xe = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    ref = jax.lax.conv_general_dilated(
        xe, jnp.asarray(wk), (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + jnp.asarray(b)
    cw = prepare_conv(wk, b, torch.float32, "cpu")
    got = reflect_conv3x3(torch.from_numpy(x), cw, relu=False, pad_mode="edge")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_rejects_unknown_pad_mode(rng):
    x, wk, b = _operands(rng, 1, 4, 4, 8, 8)
    with pytest.raises(ValueError, match="pad_mode"):
        reflect_conv3x3(torch.from_numpy(x), prepare_conv(wk, b, torch.float32, "cpu"),
                        pad_mode="zero")


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
    wk = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(np.float32)).bfloat16()
    packed = pack_weight(wk)
    if cin % 8:
        # the scalar-gather path (conv1_1): rows are HWIO's (dy, dx, ci) in
        # order, padded with zeros to its tile
        kp, np_ = packed.shape
        assert kp % TILE_K == 0 and np_ % TILE_N == 0
        assert kp >= 9 * cin and np_ >= cout
        assert torch.equal(packed[: 9 * cin, :cout].reshape(3, 3, cin, cout), wk)
        assert packed[9 * cin :].abs().sum() == 0 and packed[:, cout:].abs().sum() == 0
        return
    # the wgmma path: (n tiles, 64-channel chunks, taps, 16-byte groups, BN, 8)
    bn = igemm_layout.pick_bn(cout, NARROW_N)
    assert bn == (NARROW_N if cout == 3 else 128)
    assert packed.shape == (-(-cout // bn), cin // 64, 9, 8, bn, 8) and packed.is_contiguous()
    assert torch.equal(igemm_layout.unpack_stage_tiles(packed, cin, cout), wk)
    # one stage is one contiguous run: tile 0, chunk 0, tap (dy, dx) = (1, 2),
    # channel 2 * 8 + 5 of the chunk, output channel 1
    assert packed[0, 0, 5, 2, 1, 5] == wk[1, 2, 21, 1]
    assert torch.count_nonzero(packed) == torch.count_nonzero(wk)  # the padding is zero


# ragged shapes for the model of the kernel's addressing: planes that are no
# multiple of the 8 x 16 tile or smaller than it, one tile row, Cin ending
# inside a chunk, Cout = 3 (narrow tile), 12 (64-wide), 130 (two 128-wide tiles) and
# 264 (three)
MODEL_SHAPES = [(2, 11, 19, 24, 3), (1, 2, 2, 64, 64), (1, 8, 37, 80, 130), (3, 17, 9, 128, 12),
                (1, 3, 5, 16, 264)]


def _model_case(rng, shape, pad_mode):
    """The wgmma kernel's addressing model and the plain version, both with
    ``pad_mode``, on small integers."""
    n, h, w, cin, cout = shape
    x = rng.integers(-4, 5, (n, h, w, cin)).astype(np.float64)
    wk = torch.from_numpy(rng.integers(-4, 5, (3, 3, cin, cout)).astype(np.float32)).bfloat16()
    packed = pack_weight(wk)
    got = igemm_layout.simulate_conv(x, packed.double().numpy(), cout,
                                     reflect=pad_mode == "reflect")
    want = reflect_conv3x3_reference(torch.from_numpy(x), wk.double(), torch.zeros(cout),
                                     relu=False, pad_mode=pad_mode)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_addressing_model_equals_plain_version(rng, shape):
    """The halo gather by reflected index, the planes, the tap offsets and the
    packed weight runs, walked in numpy as the kernel walks them, give the
    plain version's sums exactly (small integers: float64 adds no rounding)."""
    _model_case(rng, shape, "reflect")


@pytest.mark.parametrize("shape", MODEL_SHAPES + [(1, 1, 9, 16, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_addressing_model_edge_mode(rng, shape):
    """The same model with the padded index clamped (the packed engine's
    level-1 convs; one row is a valid edge-padded plane)."""
    _model_case(rng, shape, "edge")


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
        (_meta((1, 4, 4, 64), torch.float16), TypeError),           # float16 raises
        (_meta((1, 4, 64, 4)).permute(0, 1, 3, 2), ValueError),     # not contiguous
        (_meta((1, 2, 1, 64)), ValueError),                         # W < 2
    ],
    ids=["h1", "cin", "f32", "strided", "w1"],  # "f32": the float16 case keeps its old id
)
def test_wrapper_rejects_what_the_kernel_does_not_take(x, error):
    cw = prepare_conv(torch.randn(3, 3, 64, 8), torch.randn(8), torch.bfloat16, "meta")
    before = reflect_conv3x3.launches
    with pytest.raises(error):
        reflect_conv3x3(x, cw)
    assert reflect_conv3x3.launches == before


def test_wrapper_rejects_weights_of_another_dtype():
    cw = prepare_conv(torch.randn(3, 3, 64, 8), torch.randn(8), torch.bfloat16, "meta")
    with pytest.raises(TypeError, match="same dtype"):
        reflect_conv3x3(_meta((1, 4, 4, 64), torch.float32), cw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("cin", [3, 16, 64])
def test_device_tensor_reaches_the_build(monkeypatch, dtype, cin):
    """bfloat16 and float32 with weights prepared in the same dtype pass every
    check and ask for the kernel library: float32 is a route of the kernel,
    not a TypeError, and nothing else serves a tensor that is not on the CPU."""
    from ccst_tpu_torch.kernels import _build

    class Reached(Exception):
        pass

    def library():
        raise Reached

    monkeypatch.setattr(_build, "library", library)
    cw = prepare_conv(torch.randn(3, 3, cin, 8), torch.randn(8), dtype, "meta")
    before = reflect_conv3x3.launches
    with pytest.raises(Reached):
        reflect_conv3x3(_meta((2, 5, 7, cin), dtype), cw)
    assert reflect_conv3x3.launches == before


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 3), (80, 130)])
def test_packed_weight_layout_float32(rng, cin, cout):
    """float32 weights stay float32. Cin % 4 != 0 (conv1_1) takes the gather
    kernel's matrix: rows HWIO's (dy, dx, ci) in order, zero padded to the
    tile. Every other Cin takes the float32 stage tiles."""
    wk = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(np.float32))
    packed = pack_weight(wk)
    assert packed.dtype == torch.float32
    cw = prepare_conv(wk, torch.zeros(cout), torch.float32, "cpu")
    assert torch.equal(cw.packed, packed) and cw.w.dtype == torch.float32
    if cin % 4 == 0:
        assert torch.equal(packed, pack_f32_stages(wk))
        return
    kp, np_ = packed.shape
    assert (kp, np_) == (-(-9 * cin // TILE_K) * TILE_K, -(-cout // TILE_N) * TILE_N)
    assert torch.equal(packed[: 9 * cin, :cout].reshape(3, 3, cin, cout), wk)
    assert packed[9 * cin :].abs().sum() == 0 and packed[:, cout:].abs().sum() == 0


@pytest.mark.parametrize("cin,cout", [(4, 3), (12, 7), (68, 130), (64, 64), (256, 256)])
def test_f32_stage_packing_round_trips(rng, cin, cout):
    """(n tiles, chunks, 9, ck, bn): one chunk's stage is one run of
    [tap][input channel][output channel], zero past Cin and Cout."""
    wk = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(np.float32))
    packed = pack_f32_stages(wk)
    t = f32_tile(f32_bn(cout))
    assert packed.shape == (-(-cout // t.bn), -(-cin // t.ck), 9, t.ck, t.bn)
    assert packed.is_contiguous() and packed.dtype == torch.float32
    assert torch.equal(unpack_f32_stages(packed, cin, cout), wk)
    assert torch.count_nonzero(packed) == torch.count_nonzero(wk)
    # tap (dy, dx) = (2, 1), input channel ck + 1 (chunk 1), output channel 2
    if cin > t.ck + 1:
        assert packed[0, 1, 7, 1, 2] == wk[2, 1, t.ck + 1, 2]


def test_f32_tiles_are_the_kernels():
    """8 x 16 pixels x 128 channels, 16 x 16 x 64, 32 x 64 x 8 or 4: 256
    threads of 8 pixels, a warp's rows on different banks of the halo."""
    got = {bn: f32_tile(bn) for bn in (4, 8, 64, 128)}
    assert [(t.th, t.tw, t.ck) for t in got.values()] == [(32, 64, 4), (32, 64, 4), (16, 16, 8),
                                                         (8, 16, 8)]
    for t in got.values():
        assert t.th * t.tw == 256 * 8 // t.cg and t.rp % 4 == 0
        starts = {(r * t.rp) % 32 for r in range(min(t.pgw, 8))}
        assert len(starts) == min(t.pgw, 8)  # float4 reads of the warp's rows: no bank conflict
    assert [f32_bn(c) for c in (3, 4, 7, 8, 9, 64, 65, 512)] == [4, 4, 8, 8, 64, 64, 128, 128]


# ragged shapes for the model of the float32 kernel: Cin 4 / 12 / 68 (chunks
# of 4 and 8 channels, a chunk half past Cin), Cout 3 / 7 / 130 / 64 / 8, planes
# that are no multiple of any tile, down to 2 x 2
F32_MODEL_SHAPES = [(2, 11, 19, 4, 3), (1, 2, 2, 12, 7), (1, 17, 9, 68, 130), (3, 5, 70, 12, 64),
                    (1, 40, 3, 4, 8), (1, 2, 3, 68, 3)]


def _f32_model_case(rng, shape, pad_mode):
    n, h, w, cin, cout = shape
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wk = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32))
    got = simulate_f32_conv(x.astype(np.float64), pack_f32_stages(wk).double().numpy(), cout,
                            reflect=pad_mode == "reflect")
    want = reflect_conv3x3_reference(torch.from_numpy(x), wk, torch.zeros(cout), relu=False,
                                     pad_mode=pad_mode)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", F32_MODEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f32_kernel_addressing_model_equals_plain_version(rng, shape):
    """The float32 stage kernel's halo planes, thread tiles, tap offsets and
    weight stages, walked in numpy, give the plain version's sums within 1e-5
    (the model sums in float64, the plain version in float32)."""
    _f32_model_case(rng, shape, "reflect")


# the packed engine's float32 level-1 shapes at a small plane: conv1_1 (Cin 16
# after its zero channels), dconv1_2 folded, dconv1_1 (Cout = 12: the 64-wide
# tile), then one row
F32_EDGE_SHAPES = [(1, 5, 18, 16, 256), (1, 3, 4, 64, 256), (2, 6, 5, 256, 12), (1, 1, 9, 12, 7)]


@pytest.mark.parametrize("shape", F32_EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_f32_kernel_addressing_model_edge_mode(rng, shape):
    """The float32 stage kernel's model with edge padding, within 1e-5."""
    _f32_model_case(rng, shape, "edge")


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


def test_package_data_ships_every_source_and_header():
    """An installed package builds from its own csrc/: every .cu and every
    ``#include "..."`` they name is covered by pyproject's package data."""
    import fnmatch
    import os
    import re
    import tomllib

    from ccst_tpu_torch.kernels import _build

    with open(os.path.join(os.path.dirname(_build._PKG), "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["ccst_tpu_torch"]
    sources = sorted(_build.CSRC.glob("*.cu"))
    needed = {f"csrc/{s.name}" for s in sources} | {
        f"csrc/{name}" for s in sources for name in re.findall(r'#include "([^"]+)"', s.read_text())
    }
    assert len(sources) >= 6 and any(n.endswith(".cuh") for n in needed)
    for rel in needed:
        assert (_build._PKG / rel).exists(), rel
        assert any(fnmatch.fnmatch(rel, g) for g in globs), f"{rel} is not in package-data {globs}"


def test_ptxas_report_parses_verbose_output():
    from ccst_tpu_torch.benchmarks.ptxas_report import parse, short_name

    name = "_ZN47_GLOBAL__N__62e5df1f_14_qconv3x3_s8_cu_2380418224qconv3x3_s8_wgmma_kernelILi128ELi1ELi2EEEvPKhS2_PKfS4_Pvi"
    assert short_name(name) == "qconv3x3_s8_wgmma_kernel<128,1,2>"
    assert short_name("_ZN3foo29reflect_conv3x3_gather_kernelEPK13__nv_bfloat16") == (
        "reflect_conv3x3_gather_kernel")
    assert short_name("_Z9something") == "_Z9something"
    # type and bool template arguments (the AdaIN and moments kernels)
    assert short_name("_ZN39_GLOBAL__N__8a1b2c3d_8_adain_cu_1234567812adain_kernel"
                      "I13__nv_bfloat16Lb1EEEvPKT_PS2_PKfS7_iiiiiiifff") == (
        "adain_kernel<__nv_bfloat16,1>")
    assert short_name("_ZN3foo22channel_moments_kernelIfEEvPKT_") == "channel_moments_kernel<float>"
    report = parse(
        "ptxas info    : (C7519) warpgroup.arrive is injected in around line 9 by compiler\n"
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    64 bytes stack frame, 124 bytes spill stores, 120 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers, 64 bytes cumulative stack size, 1024 bytes smem\n"
        "ptxas info    : Compiling entry function 'plain' for 'sm_90a'\n"
        "ptxas info    : Used 30 registers, used 1 barriers\n")
    assert report == {"injected_fences": 1, "kernels": [
        dict(kernel="qconv3x3_s8_wgmma_kernel<128,1,2>", registers=128, smem_bytes=1024,
             spill_store_bytes=124, spill_load_bytes=120),
        dict(kernel="plain", registers=30, smem_bytes=0, spill_store_bytes=0, spill_load_bytes=0)]}


@pytest.mark.parametrize("mangled,short", [
    ("_ZN47_GLOBAL__N__5d1c2e3f_18_reflect_conv3x3_cu_1a2b3c4d3f3232reflect_conv3x3_f32_stage_kernel"
     "ILi128EEEvPKfS3_S3_PfiNS0_4GeomE", "reflect_conv3x3_f32_stage_kernel<128>"),
    ("_ZN45_GLOBAL__N__7e6f5a4b_14_winograd_s8_cu_9f8e7d6c14wino_s8_kernelEPKaPKhPKfS6_Paiiiii",
     "wino_s8_kernel"),
])
def test_ptxas_report_names_this_ports_kernels(mangled, short):
    """The float32 stage kernel (inside a namespace whose name ends in
    digits) and the Winograd kernel keep their names in the report."""
    from ccst_tpu_torch.benchmarks.ptxas_report import short_name

    assert short_name(mangled) == short


def test_compare_smoke_puts_logs_side_by_side():
    from ccst_tpu_torch.benchmarks.compare_smoke import parse, table

    old = ("K1 level1 (4, 256, 256) packed: bit-exact | kernel 0.9768 ms (331.5 TOPS) bound 0.1636 ms\n"
           "B1 tiled_mm bf16 (262144, 256, 256): bit-exact | kernel 0.2781 ms (123.5 TOPS)\n"
           'device rates: {"batch": 4, "ref": {"ms": 6.56, "img_s": 1829.0}}\n'
           'not a kernel line | kernel 1.0 ms\n')
    new = ("K1 level1 (4, 256, 256) packed: bit-exact | kernel 0.3532 ms (916.8 TOPS)\n"
           "K0 qconv conv4_1 (dequant) (4, 64, 64, 256, 512) reflect dequant bf16 relu=True: "
           "bit-exact | kernel 0.0468 ms (826.0 TOPS)\n"
           'device rates: {"batch": 4, "ref": {"ms": 6.5, "img_s": 1846.0}}\n')
    assert parse(old) == {("kernel", "K1", "level1 (4, 256, 256) packed"): 0.9768,
                          ("kernel", "B1", "tiled_mm bf16 (262144, 256, 256)"): 0.2781,
                          ("engine", "ref", "batch 4"): 6.56}
    rows = {tuple(r["row"]): r["ms"] for r in table([old, new])}
    assert rows[("kernel", "K1", "level1 (4, 256, 256) packed")] == [0.9768, 0.3532]
    assert rows[("kernel", "B1", "tiled_mm bf16 (262144, 256, 256)")] == [0.2781, None]
    assert rows[("kernel", "K0", "qconv conv4_1 (dequant) (4, 64, 64, 256, 512) reflect dequant "
                 "bf16 relu=True")] == [None, 0.0468]
    assert rows[("engine", "ref", "batch 4")] == [6.56, 6.5]

