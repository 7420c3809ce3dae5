"""ccst_tpu_torch AdaIN ops and the fused-AdaIN kernel's plain version, held
against ccst_tpu (the Pallas kernel in interpret mode).

Tolerances: float32 ops rtol=1e-5, atol=1e-6 (same formulas, sums in another
order); the fused plain version vs the Pallas kernel rtol=1e-5, atol=1e-5 in
float32; bfloat16 within one bf16 ulp of the output scale (atol=2e-2). The
numpy model of the CUDA kernel's partition (``simulate_adain``: float32 sums
of the same values in the kernel's order) vs the plain version: rtol=1e-5,
atol=1e-5, the kernel's own float32 bar on the card.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.kernels.adain_pallas import fused_adain as jax_fused_adain
from ccst_tpu_torch.kernels.adain import (
    AdainPlan,
    fused_adain,
    fused_adain_multi,
    fused_adain_multi_reference,
    fused_adain_reference,
    plan_adain,
    simulate_adain,
)
from ccst_tpu_torch.ops import adain as pt_adain

# ccst_tpu.ops re-exports a function named ``adain`` over the submodule
jax_adain = importlib.import_module("ccst_tpu.ops.adain")

F32 = dict(rtol=1e-5, atol=1e-6)


def _feat(rng, shape):
    return (rng.standard_normal(shape, dtype=np.float32) * 2 + 1).astype(np.float32)


def _style(rng, c):
    s_mean = rng.standard_normal(c, dtype=np.float32)
    s_std = (rng.random(c, dtype=np.float32) + 0.1).astype(np.float32)
    return s_mean, s_std


@pytest.mark.parametrize("ddof", [0, 1])
def test_calc_mean_std_matches_jax(rng, ddof):
    feat = _feat(rng, (2, 5, 7, 16))
    m_j, s_j = jax_adain.calc_mean_std(jnp.asarray(feat), ddof=ddof)
    m_t, s_t = pt_adain.calc_mean_std(torch.from_numpy(feat), ddof=ddof)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), **F32)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **F32)


def test_adain_from_stats_and_blend_match_jax(rng):
    feat = _feat(rng, (2, 6, 6, 32))
    s_mean, s_std = _style(rng, 32)
    ref = jax_adain.alpha_blend(
        jax_adain.adain_from_stats(jnp.asarray(feat), s_mean, s_std), jnp.asarray(feat), 0.6
    )
    x = torch.from_numpy(feat)
    got = pt_adain.alpha_blend(pt_adain.adain_from_stats(x, s_mean, s_std), x, 0.6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_adain_matches_jax(rng):
    content, style = _feat(rng, (2, 6, 6, 16)), _feat(rng, (2, 4, 5, 16))
    ref = jax_adain.adain(jnp.asarray(content), jnp.asarray(style))
    got = pt_adain.adain(torch.from_numpy(content), torch.from_numpy(style))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_fused_adain_reference_matches_pallas(rng, c, alpha):
    feat = _feat(rng, (2, 8, 8, c))
    s_mean, s_std = _style(rng, c)
    ref = jax_fused_adain(jnp.asarray(feat), s_mean, s_std, alpha=alpha, interpret=True)
    got = fused_adain_reference(torch.from_numpy(feat), s_mean, s_std, alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_fused_adain_reference_bfloat16_matches_pallas(rng):
    feat = _feat(rng, (1, 8, 8, 128))
    s_mean, s_std = _style(rng, 128)
    ref = jax_fused_adain(jnp.asarray(feat, jnp.bfloat16), s_mean, s_std, alpha=0.6,
                          interpret=True)
    got = fused_adain_reference(torch.from_numpy(feat).bfloat16(), s_mean, s_std, 0.6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=2e-2)


def test_fused_adain_wrapper_on_cpu_is_the_plain_version(rng):
    feat = torch.from_numpy(_feat(rng, (2, 4, 4, 100)))  # no C % 128 rule
    s_mean, s_std = (torch.from_numpy(a) for a in _style(rng, 100))
    before = fused_adain_multi.launches  # fused_adain is its S = 1 case: one counter
    got = fused_adain(feat, s_mean, s_std, alpha=0.6)
    assert torch.equal(got, fused_adain_reference(feat, s_mean, s_std, 0.6))
    assert fused_adain_multi.launches == before  # the counter counts kernel launches only


@pytest.mark.parametrize(
    "feat,error",
    [
        (torch.empty((1, 4, 4, 8), dtype=torch.float16, device="meta"), TypeError),
        (torch.empty((1, 4, 8, 4), device="meta").permute(0, 1, 3, 2), ValueError),
    ],
    ids=["f16", "strided"],
)
def test_fused_adain_rejects_what_the_kernel_does_not_take(feat, error):
    """A meta tensor carries shape and dtype without a card: the checks the
    CUDA path makes before it launches run on it here."""
    with pytest.raises(error):
        fused_adain(feat, torch.zeros(8), torch.ones(8))


def _styles(rng, s, c):
    pairs = [_style(rng, c) for _ in range(s)]
    return np.stack([m for m, _ in pairs]), np.stack([d for _, d in pairs])


@pytest.mark.parametrize("alpha", [1.0, 0.6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_multi_reference_is_one_reference_call_a_style(rng, alpha, dtype):
    feat = torch.from_numpy(_feat(rng, (2, 5, 7, 24))).to(dtype)
    s_means, s_stds = _styles(rng, 3, 24)
    got = fused_adain_multi_reference(feat, torch.from_numpy(s_means), torch.from_numpy(s_stds),
                                      alpha)
    assert got.shape == (3, 2, 5, 7, 24) and got.dtype == dtype
    for s in range(3):
        assert torch.equal(got[s], fused_adain_reference(feat, s_means[s], s_stds[s], alpha))


def test_multi_wrapper_on_cpu_is_the_plain_version(rng):
    feat = torch.from_numpy(_feat(rng, (1, 3, 4, 20)))
    s_means, s_stds = (torch.from_numpy(a) for a in _styles(rng, 2, 20))
    before = fused_adain_multi.launches
    got = fused_adain_multi(feat, s_means, s_stds, alpha=0.6, ddof=0)
    assert torch.equal(got, fused_adain_multi_reference(feat, s_means, s_stds, 0.6, ddof=0))
    assert fused_adain_multi.launches == before


def test_multi_reference_matches_jax_ops_and_pallas(rng):
    """The same features under every style: ccst_tpu's adain_from_stats +
    alpha_blend per style, and its Pallas kernel in interpret mode."""
    feat = _feat(rng, (2, 8, 8, 128))
    s_means, s_stds = _styles(rng, 3, 128)
    got = fused_adain_multi_reference(torch.from_numpy(feat), torch.from_numpy(s_means),
                                      torch.from_numpy(s_stds), 0.6).numpy()
    x = jnp.asarray(feat)
    for s in range(3):
        ops = jax_adain.alpha_blend(jax_adain.adain_from_stats(x, s_means[s], s_stds[s]), x, 0.6)
        np.testing.assert_allclose(got[s], np.asarray(ops), rtol=1e-5, atol=1e-5)
        pallas = jax_fused_adain(x, s_means[s], s_stds[s], alpha=0.6, interpret=True)
        np.testing.assert_allclose(got[s], np.asarray(pallas), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "hw,plan",
    [
        (64 * 64, AdainPlan(8, 512, True)),      # relu4_1 at 512 px
        (32 * 32, AdainPlan(8, 128, True)),      # 256 px still spreads over 8 blocks a slice
        (16 * 16, AdainPlan(2, 128, True)),
        (7 * 9, AdainPlan(1, 63, True)),         # small map: one block a slice
        (1, AdainPlan(1, 1, True)),
        (119 * 119, AdainPlan(8, 1771, True)),   # the largest resident map
        (128 * 128, AdainPlan(8, 2048, False)),  # streamed
        (37 * 53, AdainPlan(8, 246, True)),      # ragged rows: the last block holds fewer
    ],
)
def test_plan_adain(hw, plan):
    assert plan_adain(hw) == plan
    assert plan.cluster * plan.rows_per_block >= hw  # every row has a block


# ragged shapes for the model of the kernel's partition: a channel count off
# the 128-byte group, one pixel (ddof: max(hw - ddof, 1)), rows off the
# cluster and off the 32-row sweep, and a map split over 8 blocks
MODEL_SHAPES = [(1, 4, 5, 500), (2, 1, 1, 16), (1, 37, 53, 12), (2, 7, 9, 100), (1, 40, 40, 8)]


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("alpha,ddof", [(1.0, 1), (0.6, 0)])
def test_partition_model_equals_plain_version(rng, shape, alpha, ddof):
    """Rows over the cluster's blocks, block sums in the kernel's order,
    partials in rank order: within the float32 bar of the plain version, and
    the same bits on a second run (no sum depends on anything but the shape)."""
    feat = _feat(rng, shape)
    s_means, s_stds = _styles(rng, 2, shape[-1])
    got = simulate_adain(feat, s_means, s_stds, alpha, ddof=ddof)
    want = fused_adain_multi_reference(torch.from_numpy(feat), torch.from_numpy(s_means),
                                       torch.from_numpy(s_stds), alpha, ddof=ddof)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)
    again = simulate_adain(feat.copy(), s_means, s_stds, alpha, ddof=ddof)
    assert got.tobytes() == again.tobytes()


@pytest.mark.parametrize(
    "feat,stats,error",
    [
        (torch.empty((1, 4, 4, 8), dtype=torch.float16, device="meta"), (2, 8), TypeError),
        (torch.empty((1, 4, 8, 4), device="meta").permute(0, 1, 3, 2), (2, 8), ValueError),
        (torch.empty((1, 4, 4, 8), device="meta"), (2, 7), ValueError),
        (torch.empty((1, 4, 4, 8), device="meta"), (0, 8), ValueError),
        (torch.empty((0, 4, 4, 8), device="meta"), (2, 8), ValueError),
    ],
    ids=["f16", "strided", "channels", "no-style", "empty"],
)
def test_fused_adain_multi_rejects_what_the_kernel_does_not_take(feat, stats, error):
    before = fused_adain_multi.launches
    with pytest.raises(error):
        fused_adain_multi(feat, torch.zeros(stats), torch.ones(stats))
    assert fused_adain_multi.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_fused_adain_on_a_device_tensor_reaches_the_build(monkeypatch, dtype):
    """What the kernel takes passes every check and asks for the kernel
    library: there is no other path for a tensor that is not on the CPU."""
    from ccst_tpu_torch.kernels import _build

    class Reached(Exception):
        pass

    def library():
        raise Reached

    monkeypatch.setattr(_build, "library", library)
    feat = torch.empty((2, 4, 4, 500), dtype=dtype, device="meta")
    with pytest.raises(Reached):
        fused_adain(feat, torch.zeros(500), torch.ones(500))
    with pytest.raises(Reached):
        fused_adain_multi(feat, torch.zeros((3, 500)), torch.ones((3, 500)))
