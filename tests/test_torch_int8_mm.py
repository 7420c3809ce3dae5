"""B1's plain version (ccst_tpu_torch.kernels.int8_mm) held against the JAX
project's ``benchmarks/pallas_int8_mxu.py::pallas_mm``, run in TPU interpret
mode on the CPU, bit for bit: the same int8 operands made from a seed with
numpy, in the three variants int8 -> int32, int8 -> float32 and bf16 ->
float32.

The float32 outputs are compared bit for bit at K <= 1024 only: there every
|partial sum| <= 127**2 * 1024 < 2**24, so a float32 accumulation is exact in
any order and equals the exact sum the plain version rounds. Above that a
float32 sum may round, in an order that differs between the two.

On the CPU the wrapper runs the plain version; the CUDA kernel is held to the
same plain version on the card by chip_smoke.py. Its addressing (work items, A
planes, packed weight stages) is held to the plain version here through the
numpy model ``int8_mm.simulate_mm``, at ragged M, K and N.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ccst_tpu_torch.kernels import int8_mm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_bench(name):
    """A JAX harness under benchmarks/ (not a package), loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_bench_{name}",
                                                  os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mxu():
    return _jax_bench("pallas_int8_mxu")


VARIANTS = {"i8i32": (torch.int8, torch.int32, jnp.int8, jnp.int32),
            "i8f32": (torch.int8, torch.float32, jnp.int8, jnp.float32),
            "bf16": (torch.bfloat16, torch.float32, jnp.bfloat16, jnp.float32)}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("k,n", [(256, 128), (576, 256), (1024, 64)])
def test_plain_version_matches_pallas_mm(rng, mxu, variant, k, n):
    t_in, t_out, j_in, j_out = VARIANTS[variant]
    x = rng.integers(-127, 127, (256, k)).astype(np.int8)
    w = rng.integers(-127, 127, (k, n)).astype(np.int8)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(mxu.pallas_mm(jnp.asarray(x, j_in), jnp.asarray(w, j_in), j_out,
                                       tile_m=128))
    mw = int8_mm.prepare_mm_weight(torch.from_numpy(w).to(t_in))
    got = int8_mm.tiled_mm(torch.from_numpy(x).to(t_in), mw, t_out)
    assert got.dtype == t_out and got.shape == (256, n)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype,kp", [(torch.int8, 64), (torch.bfloat16, 32)])
def test_weight_layout(rng, dtype, kp):
    """The packed weights are the bytes of the kernel's shared-memory stages:
    element [n tile, chunk, group, n, i] is w[k, column] with k = chunk * (128
    bytes) + group * (16 bytes) + i, zero where K ends inside a chunk (here
    halfway through the second) or N inside a tile; unpacking gives w back."""
    k, n = 3 * kp, 136
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dtype)
    mw = int8_mm.prepare_mm_weight(w)
    per_group = 16 // w.element_size()
    assert mw.wt.shape == (2, 2, 8, int8_mm.TILE_N, per_group) and mw.wt.dtype == dtype
    assert mw.wt.is_contiguous()
    t, c, g, col, i = np.indices(tuple(mw.wt.shape))
    kk, nn = (c * 8 + g) * per_group + i, t * int8_mm.TILE_N + col
    inside = (kk < k) & (nn < n)
    want = np.where(inside, w.float().numpy()[np.minimum(kk, k - 1), np.minimum(nn, n - 1)], 0.0)
    np.testing.assert_array_equal(mw.wt.float().numpy(), want)
    assert torch.equal(int8_mm.unpack_mm_weight(mw.wt, k, n), w)


def test_swizzle_keeps_a_row_in_its_128_bytes():
    """The 128-byte swizzle permutes the eight 16-byte pieces of a row among
    themselves, by the row's index in its group of eight; rows 8 apart look
    alike (the pattern the tensor map writes and the A descriptor reads)."""
    rows, pieces = np.meshgrid(np.arange(int8_mm.TILE_M), np.arange(8), indexing="ij")
    where = int8_mm.swizzle128(rows, pieces)
    assert sorted(where.ravel().tolist()) == list(range(8 * int8_mm.TILE_M))
    np.testing.assert_array_equal(where // 8, rows)
    np.testing.assert_array_equal(where[0], np.arange(8))
    np.testing.assert_array_equal(where[5] % 8, np.arange(8) ^ 5)
    np.testing.assert_array_equal(where[8:] - where[:-8], 64)


# ragged M (below one wgmma, off the 192-row item, over several items), K ending
# inside a 128-byte stage in both element types, N off the 128-column tile
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("m,k,n", [(300, 80, 40), (5, 256, 128), (77, 272, 136), (513, 48, 24)])
def test_simulated_kernel_matches_plain_version(rng, variant, m, k, n):
    """The numpy walk of the kernel's work items, A planes and packed weight
    stages gives the plain version's result exactly (integer sums; the float32
    ones stay below 2**24)."""
    t_in, t_out, _, _ = VARIANTS[variant]
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(t_in)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(t_in)
    packed = int8_mm.pack_mm_weight(w)
    acc = np.int64 if t_in == torch.int8 else np.float64
    got = int8_mm.simulate_mm(x.float().numpy().astype(acc), packed.float().numpy().astype(acc), n)
    want = int8_mm.tiled_mm_reference(x, w, t_out)
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got.astype(want.numpy().dtype), want.numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    w = torch.from_numpy(rng.integers(-127, 128, (32, 16)).astype(np.int8))
    mw = int8_mm.prepare_mm_weight(w)
    with pytest.raises(TypeError):  # bf16 input for int8 weights
        int8_mm.tiled_mm(torch.zeros((4, 32), dtype=torch.bfloat16), mw, torch.float32)
    with pytest.raises(TypeError):  # int8 -> bf16 is not a variant
        int8_mm.tiled_mm(torch.zeros((4, 32), dtype=torch.int8), mw, torch.bfloat16)
    with pytest.raises(ValueError):  # K mismatch
        int8_mm.tiled_mm(torch.zeros((4, 16), dtype=torch.int8), mw, torch.int32)
    # the CUDA path's checks run on meta tensors, before anything is built
    meta = int8_mm.prepare_mm_weight(torch.empty((8, 16), dtype=torch.int8, device="meta"))
    before = int8_mm.tiled_mm.launches
    with pytest.raises(ValueError, match="16 bytes"):
        int8_mm.tiled_mm(torch.empty((4, 8), dtype=torch.int8, device="meta"), meta, torch.int32)
    assert int8_mm.tiled_mm.launches == before


def test_harness_runs_plain_on_cpu(capsys):
    from ccst_tpu_torch.benchmarks import int8_mm as harness

    res = harness.main(["--device", "cpu", "--m", "130", "--shapes", "64x32,48x16"])
    assert res["exact_64x32"] and res["exact_48x16"] and res["device"] == "cpu"
    assert not any(k.startswith(("kernel_", "cublas_")) for k in res)  # no CPU timings
    assert len(capsys.readouterr().out.strip().splitlines()) == 2  # one line per shape
    args = harness.parse_args(["--shapes", "64x32,48x16", "--reps", "2", "--runs", "3"])
    assert harness.planned_launches(args) == {"tiled_mm": 2 * 3 * (1 + 1 + 2 * 3)}
