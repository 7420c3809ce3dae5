"""ccst_tpu_torch AdaIN ops and the fused-AdaIN kernel's plain version, held
against ccst_tpu (the Pallas kernel in interpret mode).

Tolerances: float32 ops rtol=1e-5, atol=1e-6 (same formulas, sums in another
order); the fused plain version vs the Pallas kernel rtol=1e-5, atol=1e-5 in
float32; bfloat16 within one bf16 ulp of the output scale (atol=2e-2).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.kernels.adain_pallas import fused_adain as jax_fused_adain
from ccst_tpu_torch.kernels.adain import fused_adain, fused_adain_reference
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
    before = fused_adain.launches
    got = fused_adain(feat, s_mean, s_std, alpha=0.6)
    assert torch.equal(got, fused_adain_reference(feat, s_mean, s_std, 0.6))
    assert fused_adain.launches == before  # the counter counts kernel launches only


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
