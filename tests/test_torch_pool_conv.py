"""B3's plain version (ccst_tpu_torch.kernels.pool_conv) held against the JAX
project's ``benchmarks/fused_pool_conv_ab.py``, bit for bit: its fused
Pallas kernel in interpret mode (F9 and F3) and its production chain
(``phase_max`` -> ``_qconv_s(..., "reflect")``), on the packed int8 input its
``check_correctness`` draws, with the conv2_1 weights of its ``build_prep``.
The port's ``build_prep`` gives the same int8 weights and epilogue terms from
the same float weights, carried across as a ``.npz`` file.

On the CPU the wrapper runs the plain version; the CUDA kernel is held to the
same plain version on the card by chip_smoke.py. Its addressing (the pooled
halo planes by reflect index, the 64-byte weight stages, the accumulator
columns) is held here through the numpy model ``pool_conv.simulate_pool_conv``.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.models import convert as jconvert
from ccst_tpu.models import vgg as jvgg
from ccst_tpu_torch.kernels import igemm_layout, pool_conv
from ccst_tpu_torch.kernels.qconv import make_qconv
from ccst_tpu_torch.models import convert as tconvert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fpc():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_fused_pool_conv_ab", os.path.join(REPO, "benchmarks", "fused_pool_conv_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def prep(fpc):
    q, wq, k, kb = fpc.build_prep()
    return q, np.asarray(wq), np.asarray(k), np.asarray(kb)


def _xp(seed, shape):
    return np.random.default_rng(seed).integers(-5, 120, shape).astype(np.int8)


@pytest.mark.parametrize("cat", [False, True], ids=["F9", "F3"])
def test_plain_version_matches_pool_conv_fused(fpc, prep, cat):
    q, wq, k, kb = prep
    xp = _xp(1, (1, 16, 16, 256))
    ref = np.asarray(fpc.pool_conv_fused(jnp.asarray(xp), jnp.asarray(wq), k, kb, ht=8, cat=cat,
                                         interpret=True))
    ours = make_qconv(wq, k, kb, False, True, "cpu")
    got = pool_conv.pool_conv_fused(torch.from_numpy(xp), ours, cat).numpy()
    assert got.shape == (1, 16, 16, 128) and len(np.unique(got)) > 20
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(fpc.production(q)(jnp.asarray(xp))))


@pytest.mark.parametrize("shape", [(1, 7, 5, 256), (2, 2, 3, 256)])
def test_odd_planes_match_the_production_chain(fpc, prep, shape):
    """Any Hb, Wb >= 2; the reference's kernel takes only whole 8-row tiles,
    its production chain any plane."""
    q, wq, k, kb = prep
    xp = _xp(2, shape)
    got = pool_conv.pool_conv_fused(torch.from_numpy(xp), make_qconv(wq, k, kb, False, True, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(fpc.production(q)(jnp.asarray(xp))))


@pytest.mark.parametrize("cat", [False, True], ids=["F9", "F3"])
def test_simulated_kernel_matches_pool_conv_fused(fpc, prep, cat):
    """The kernel's addressing against the JAX harness's fused kernel."""
    _, wq, k, kb = prep
    xp = _xp(1, (1, 16, 16, 256))
    ref = np.asarray(fpc.pool_conv_fused(jnp.asarray(xp), jnp.asarray(wq), k, kb, ht=8, cat=cat,
                                         interpret=True))
    ours = make_qconv(wq, k, kb, False, True, "cpu")
    got = pool_conv.simulate_pool_conv(xp, ours, pool_conv.prepare_pool_conv(ours), cat)
    np.testing.assert_array_equal(got, ref)


# odd planes, the smallest reflectable plane, several tiles each way; Cout on
# the 128-wide, the 64-wide and the narrow tile, and over two 128-wide tiles
@pytest.mark.parametrize("cat", [False, True], ids=["F9", "F3"])
@pytest.mark.parametrize("shape,cout", [((1, 7, 13), 128), ((2, 2, 2), 128), ((3, 33, 5), 128),
                                        ((1, 9, 20), 64), ((1, 7, 13), 12), ((1, 5, 18), 136)],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_simulated_kernel_matches_plain_version(shape, cout, cat):
    rng = np.random.default_rng(3)
    wq = rng.integers(-127, 128, (3, 3, 64, cout)).astype(np.int8)
    k = (rng.uniform(0.5, 1.5, cout) * 40 / (127 * 73 * 24)).astype(np.float32)
    q = make_qconv(wq, k, (rng.standard_normal(cout) * 10).astype(np.float32), False, True, "cpu")
    xp = _xp(4, (*shape, 256))
    want = pool_conv.pool_conv_reference(torch.from_numpy(xp), q).numpy()
    assert len(np.unique(want)) > 20  # the outputs spread, so equality says something
    got = pool_conv.simulate_pool_conv(xp, q, pool_conv.prepare_pool_conv(q), cat)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cout,bn", [(128, 128), (64, 64), (12, 16), (136, 128)])
def test_pool_conv_weight_layout(cout, bn):
    """64-byte stage tiles: K0's output-channel tile, four 16-byte groups (no
    zero half), the nine taps of a tile one run; they round-trip to HWIO."""
    rng = np.random.default_rng(5)
    wq = rng.integers(-127, 128, (3, 3, 64, cout)).astype(np.int8)
    q = make_qconv(wq, np.ones(cout, np.float32), np.zeros(cout, np.float32), False, True, "cpu")
    wp = pool_conv.prepare_pool_conv(q)
    assert wp.shape == (-(-cout // bn), 1, 9, 4, bn, 16) and wp.is_contiguous()
    assert wp.numel() == -(-cout // bn) * bn * 9 * 64  # dense in K
    assert torch.equal(igemm_layout.unpack_stage_tiles(wp, 64, cout), q.wq)


def test_wrapper_takes_prepared_weights(prep):
    _, wq, k, kb = prep
    q = make_qconv(wq, k, kb, False, True, "cpu")
    xp = torch.from_numpy(_xp(6, (1, 4, 6, 256)))
    assert torch.equal(pool_conv.pool_conv_fused(xp, q, True, pool_conv.prepare_pool_conv(q)),
                       pool_conv.pool_conv_fused(xp, q, True))


def test_build_prep_matches_jax(fpc, prep, tmp_path):
    """The same conv2_1 weights (JAX's PRNGKey(0) encoder through a .npz
    file) give the same int8 weights, k and kb."""
    _, wq, k, kb = prep
    path = str(tmp_path / "enc.npz")
    jconvert.save_npz(path, jvgg.init_params(jax.random.PRNGKey(0), jvgg.ENCODER_ARCH))
    conv2_1 = tconvert.load_npz(path)["conv2_1"]
    from ccst_tpu_torch.benchmarks.fused_pool_conv_ab import build_prep

    ours = build_prep(w=conv2_1["w"].numpy(), b=conv2_1["b"].numpy())
    for a, b in zip(ours, (wq, k, kb)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_wrapper_rejects_what_the_kernel_does_not_take(prep):
    _, wq, k, kb = prep
    q = make_qconv(wq, k, kb, False, True, "cpu")
    with pytest.raises(ValueError, match="256"):
        pool_conv.pool_conv_fused(torch.zeros((1, 4, 4, 64), dtype=torch.int8), q)
    with pytest.raises(ValueError, match="requantizing"):
        pool_conv.pool_conv_fused(torch.zeros((1, 4, 4, 256), dtype=torch.int8),
                                  make_qconv(wq, k, kb, False, False, "cpu"))
    # the CUDA path's checks run on meta tensors, before anything is built
    meta = make_qconv(wq, k, kb, False, True, "meta")
    before = pool_conv.pool_conv_fused.launches
    with pytest.raises(ValueError, match="Hb, Wb >= 2"):
        pool_conv.pool_conv_fused(torch.empty((1, 1, 4, 256), dtype=torch.int8, device="meta"),
                                  meta)
    assert pool_conv.pool_conv_fused.launches == before


def test_harness_runs_plain_on_cpu():
    from ccst_tpu_torch.benchmarks import fused_pool_conv_ab as harness

    res = harness.main(["--device", "cpu", "--batch", "1", "--spatial", "9"])
    assert res["correctness"] == {"F9": "bit-exact", "F3": "bit-exact"}
    assert res["exact_vs_production"] and res["shape"] == [1, 9, 9, 256]
    assert not any(k.endswith("_ms") for k in res)  # no CPU timings
    args = harness.parse_args(["--reps", "2", "--runs", "3"])
    assert harness.planned_launches(args) == {"qconv3x3_s8": 9, "pool_conv_fused": 18}
