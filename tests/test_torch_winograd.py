"""B2's plain versions (ccst_tpu_torch.kernels.winograd) held against the JAX
project's ``benchmarks/winograd_ab.py::conv_kernel`` in Pallas interpret mode,
bit for bit: the direct 9-tap conv and Winograd F(2x2, 3x3) in its ``full``
and ``tf`` modes, on int8 inputs and weights made from a seed with numpy, with
the harness's weight recipe. ``wino_weights`` equals the reference's array for
array.

The reference's padding is not a centred conv (``_pad_input`` pads 2 rows on
top, the kernels read from padded row 0): output row h is the edge-padded conv
centred on input row h - 1. The port copies it; ``test_direct_row_offset``
pins it, and ROADMAP.md lists it among the gaps in the reference.

On the CPU the wrappers run the plain versions; the CUDA kernels are held to
the same plain versions on the card by chip_smoke.py. Here the numpy models of
their addressing are held to the plain versions bit for bit: the direct conv
is K0's kernel with a row shift (``igemm_layout.simulate_conv``), the Winograd
kernel's halo planes, position planes, stages and phase sums are
``winograd.simulate_wino``.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.models import vgg_fast as jf
from ccst_tpu_torch.kernels import qconv, winograd
from ccst_tpu_torch.kernels.igemm_layout import requant_relu, simulate_conv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wab():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_winograd_ab", os.path.join(REPO, "benchmarks", "winograd_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(seed, shape, cout, k_scale=1.0):
    """The harness's recipe: x in [0, 100), w ~ N(0, 0.05) quantized per
    output channel, kb ~ N(0, 0.1); ``k_scale`` spreads the tf-mode outputs."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 100, shape).astype(np.int8)
    w = rng.normal(0, 0.05, (3, 3, shape[-1], cout)).astype(np.float32)
    wq, ws = jf._quantize_kernel(w)
    wq, ws = np.asarray(wq), np.asarray(ws)
    kb = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    uq, su = winograd.wino_weights(wq)
    k_dir = ws.reshape(-1) * np.float32(k_scale)
    k_wino = su * ws.reshape(-1) * np.float32(k_scale)
    return x, wq, uq, k_dir, k_wino, kb


def test_wino_weights_match_jax(wab):
    _, wq, uq, *_ = _case(0, (1, 4, 4, 64), 128)
    theirs_u, theirs_s = wab.wino_weights(wq)
    ours_u, ours_s = winograd.wino_weights(wq)
    assert ours_u.dtype == np.int8 and ours_s.dtype == np.float32
    np.testing.assert_array_equal(ours_u, np.asarray(theirs_u))
    np.testing.assert_array_equal(ours_s, np.asarray(theirs_s))


def test_direct_matches_jax(wab):
    x, wq, uq, k_dir, k_wino, kb = _case(1, (1, 16, 64, 64), 64)
    c = winograd.make_wino_conv(wq, uq, k_dir, k_wino, kb, "cpu")
    ref = np.asarray(wab.conv_kernel(jnp.asarray(x), jnp.asarray(wq.reshape(9, 64, 64)), k_dir,
                                     kb, ht=16, kind="direct", interpret=True))
    got = winograd.conv_direct(torch.from_numpy(x), c).numpy()
    assert len(np.unique(got)) > 20
    np.testing.assert_array_equal(got, ref)


def test_direct_row_offset():
    """Gap in the reference: output row h is the centred edge conv of row
    h - 1 (rows 1.. equal the production conv's rows ..-1), and row 0 is not
    the production conv's row 0."""
    x, wq, uq, k_dir, k_wino, kb = _case(1, (1, 16, 64, 64), 64)
    c = winograd.make_wino_conv(wq, uq, k_dir, k_wino, kb, "cpu")
    got = winograd.conv_direct(torch.from_numpy(x), c).numpy()
    centred = qconv.qconv3x3_s8_reference(torch.from_numpy(x), c.direct.wq, c.direct.k, c.kb,
                                          True, True, torch.int8, "edge").numpy()
    np.testing.assert_array_equal(got[:, 1:], centred[:, :-1])
    assert not np.array_equal(got[:, 0], centred[:, 0])


@pytest.mark.parametrize("mode,k_scale", [("full", 1.0), ("tf", 2e3)])
def test_wino_matches_jax(wab, mode, k_scale):
    x, wq, uq, k_dir, k_wino, kb = _case(2, (1, 16, 64, 64), 64, k_scale)
    c = winograd.make_wino_conv(wq, uq, k_dir, k_wino, kb, "cpu")
    ref = np.asarray(wab.conv_kernel(jnp.asarray(x), jnp.asarray(uq), k_wino, kb, ht=16, wt=64,
                                     kind="wino", mode=mode, interpret=True))
    got = winograd.conv_wino(torch.from_numpy(x), c, mode).numpy()
    assert len(np.unique(got)) > 20
    np.testing.assert_array_equal(got, ref)


def test_wino_odd_plane_matches_jax_on_the_edge_extended_plane(wab):
    """Any plane runs. The edge padding clamps, so the conv of an odd plane is
    the conv of the plane extended by edge replication, cropped; the
    reference needs whole tiles and takes the extended one."""
    x, wq, uq, k_dir, k_wino, kb = _case(3, (2, 7, 9, 64), 128)
    c = winograd.make_wino_conv(wq, uq, k_dir, k_wino, kb, "cpu")
    ext = np.pad(x, ((0, 0), (0, 1), (0, 7), (0, 0)), mode="edge")  # (2, 8, 16, 64)
    ref = np.asarray(wab.conv_kernel(jnp.asarray(ext), jnp.asarray(uq), k_wino, kb, ht=8, wt=16,
                                     kind="wino", mode="full", interpret=True))
    got = winograd.conv_wino(torch.from_numpy(x), c, "full").numpy()
    np.testing.assert_array_equal(got, ref[:, :7, :9])


def test_dots_mode_feeds_the_raw_corner_pixel():
    """``dots`` elides the transform: every position's V is the tile's raw
    corner pixel, so the result is the corner through sum(A^T-signed U)."""
    x, wq, uq, k_dir, k_wino, kb = _case(4, (1, 6, 10, 64), 64, 0.05)
    c = winograd.make_wino_conv(wq, uq, k_dir, k_wino, kb, "cpu")
    got = winograd.conv_wino(torch.from_numpy(x), c, "dots").numpy()
    xp = np.pad(x, ((0, 0), (2, 0), (1, 0), (0, 0)), mode="edge").astype(np.int64)
    at = winograd.AT.astype(np.int64)
    for a in (0, 1):
        for b in (0, 1):
            u_ab = sum(at[a, p // 4] * at[b, p % 4] * uq[p].astype(np.int64) for p in range(16))
            acc = xp[:, 0:6:2, 0:10:2] @ u_ab  # the corner of every 2x2 tile
            y = acc.astype(np.float32) * k_wino + kb
            want = np.clip(np.rint(y), 0, 127).astype(np.int8)
            np.testing.assert_array_equal(got[:, a::2, b::2], want)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, wq, uq, k_dir, k_wino, kb = _case(5, (1, 4, 4, 64), 128)
    c = winograd.make_wino_conv(wq, uq, k_dir, k_wino, kb, "cpu")
    with pytest.raises(ValueError, match="mode"):
        winograd.conv_wino(torch.from_numpy(x), c, "fast")
    # the CUDA path's checks run on meta tensors, before anything is built
    meta = winograd.make_wino_conv(wq, uq, k_dir, k_wino, kb, "meta")
    xm = torch.empty((1, 4, 4, 64), dtype=torch.int8, device="meta")
    before = winograd.conv_wino.launches, winograd.conv_direct.launches
    with pytest.raises(ValueError, match="Cout <= Cin"):
        winograd.conv_wino(xm, meta, "tf")
    odd = winograd.make_wino_conv(*_case(5, (1, 4, 4, 32), 64)[1:], "meta")
    with pytest.raises(ValueError, match="multiples of 64"):
        winograd.conv_wino(torch.empty((1, 4, 4, 32), dtype=torch.int8, device="meta"), odd)
    # the direct conv is K0's wgmma route with a row shift: 16-byte channel groups
    narrow = winograd.make_wino_conv(*_case(5, (1, 4, 4, 12), 64)[1:], "meta")
    with pytest.raises(ValueError, match="row shift needs Cin % 16"):
        winograd.conv_direct(torch.empty((1, 4, 4, 12), dtype=torch.int8, device="meta"), narrow)
    assert (winograd.conv_wino.launches, winograd.conv_direct.launches) == before


def test_harness_runs_plain_on_cpu():
    from ccst_tpu_torch.benchmarks import winograd_ab as harness

    res = harness.main(["--device", "cpu", "--batch", "1", "--spatial", "12", "--cin", "64",
                        "--cout", "64"])
    assert res["shape"] == [1, 12, 12, 64] and res["device"] == "cpu"
    assert 20.0 < res["psnr_wino_vs_direct_db"] < 80.0 and res["mean_abs_lsb"] > 0
    assert not any(k.endswith("_ms") for k in res)  # no CPU timings
    args = harness.parse_args(["--reps", "2", "--runs", "3"])
    assert harness.planned_launches(args) == {"qconv3x3_s8": 7, "conv_direct": 8, "conv_wino": 22}


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 192), (192, 128)])
def test_wino_stage_packing_round_trips(cin, cout):
    """(n tiles, chunks, 16, 4, 128, 16): one position's stage of one chunk is
    8 KB, [16-byte group of K][output channel][16 input channels], zero past
    Cout."""
    uq = np.random.default_rng(cin + cout).integers(-127, 128, (16, cin, cout)).astype(np.int8)
    up = winograd.pack_wino_stages(uq)
    tiles = -(-cout // winograd.WINO_N)
    assert up.shape == (tiles, cin // 64, 16, 4, 128, 16) and up.flags.c_contiguous
    np.testing.assert_array_equal(winograd.unpack_wino_stages(up, cin, cout), uq)
    assert np.count_nonzero(up) == np.count_nonzero(uq)
    # position 5, input channel 64 + 16 + 3 (chunk 1, group 1), output channel 130 (tile 1)
    if cin > 83 and cout > 130:
        assert up[1, 1, 5, 1, 2, 3] == uq[5, 83, 130]


# the A/B's ragged shapes (chip_smoke.py B2_EDGE): odd planes, one row; then
# a plane smaller than one block with two chunks, two n tiles of which one is
# half past Cout
B2_MODEL_SHAPES = [(1, 17, 37, 64, 64), (2, 9, 20, 128, 64), (1, 1, 3, 64, 128),
                   (2, 5, 7, 128, 64), (1, 6, 18, 64, 192)]


@pytest.mark.parametrize("shape", B2_MODEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_direct_model_on_k0s_core_equals_plain_version(shape):
    """conv_direct is K0's kernel with row_shift = 1: its halo gather, planes,
    taps and stages (simulate_conv) give the plain version's bits."""
    x, wq, uq, k_dir, k_wino, kb = _case(6, shape[:4], shape[4], k_scale=0.5)
    c = winograd.make_wino_conv(wq, uq, k_dir, k_wino, kb, "cpu")
    sums = simulate_conv(x.astype(np.int64), c.direct.wp.numpy().astype(np.int64), shape[4],
                         reflect=False, row_shift=1)
    got = requant_relu(sums, k_dir, kb).astype(np.int8)
    want = winograd.conv_direct_reference(torch.from_numpy(x), c).numpy()
    assert len(np.unique(want)) > 5
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,mode", [(s, m) for s in B2_MODEL_SHAPES for m in winograd.MODES
                                        if m != "tf" or s[4] <= s[3]],  # tf: Cout <= Cin
                         ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_wino_kernel_model_equals_plain_version(shape, mode):
    """The Winograd kernel's halo planes (even columns, then odd), transform
    into 16 position planes, descriptor walks of V and of the U stages, phase
    sums with A^T's signs and row-to-tile map (simulate_wino), then the
    kernel's epilogue, give conv_wino_reference's bits in every mode."""
    n, h, w, cin, cout = shape
    x, wq, uq, k_dir, k_wino, kb = _case(7, (n, h, w, cin), cout,
                                         {"full": 1.0, "dots": 0.05, "tf": 2e3}[mode])
    c = winograd.make_wino_conv(wq, uq, k_dir, k_wino, kb, "cpu")
    sums = winograd.simulate_wino(x, c.up.numpy(), cout, mode)
    got = requant_relu(sums, k_wino, kb).astype(np.int8)
    want = winograd.conv_wino_reference(torch.from_numpy(x), c, mode).numpy()
    assert len(np.unique(want)) > 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["no-adds", "no-products", "neither"])
def test_ablation_cuts_what_it_names_out_of_the_kernel(name):
    """benchmarks/wino_ablation.py times copies of csrc/winograd_s8.cu with
    statements replaced by empty ones; each must still be found in the
    kernel's source, and nothing else may change."""
    from ccst_tpu_torch.benchmarks import wino_ablation as ab

    source = open(os.path.join(REPO, "ccst_tpu_torch", "csrc", "winograd_s8.cu")).read()
    assert ab.variant_source(source, "kernel") == source
    cut = ab.variant_source(source, name)
    removed = sum(source.count(c) * (len(c) - 1) for c in ab.VARIANTS[name])  # each left as ";"
    assert len(source) - len(cut) == removed > 0
    with pytest.raises(ValueError, match="no longer holds"):
        ab.variant_source(cut, name)
