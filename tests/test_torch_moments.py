"""Per-channel moments (the K5 kernel's plain version), Welford merge and
finalize, and the style-bank step of ccst_tpu_torch, held against ccst_tpu
(the Pallas kernel in interpret mode).

Tolerances, as tests/test_kernels.py states them for the Pallas kernel:
float32 mean rtol=1e-5, M2 rtol=1e-4; the bank step through the float32
encoder rtol=1e-4, atol=1e-6. The numpy model of the CUDA kernel's partition
(``simulate_moments``) is held to the plain version at the kernel's own bar on
the card: mean rtol=1e-5, M2 rtol=1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.kernels.welford_pallas import channel_moments as jax_channel_moments
from ccst_tpu.ops import welford as jw
from ccst_tpu_torch.kernels.moments import (
    MomentsPlan,
    channel_moments,
    channel_moments_reference,
    plan_moments,
    simulate_moments,
)
from ccst_tpu_torch.ops import welford as tw


@pytest.mark.parametrize("shape", [(3, 8, 8, 128), (2, 4, 6, 256)])
def test_reference_matches_pallas_moments(rng, shape):
    feat = (rng.standard_normal(shape, dtype=np.float32) * 3 + 10).astype(np.float32)
    m_j, m2_j, n_j = jax_channel_moments(jnp.asarray(feat), interpret=True)
    m_t, m2_t, n_t = channel_moments_reference(torch.from_numpy(feat))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-5)
    np.testing.assert_allclose(m2_t.numpy(), np.asarray(m2_j), rtol=1e-4)
    assert float(n_t) == float(n_j) == np.prod(shape[:3])


def test_wrapper_on_cpu_is_the_plain_version(rng):
    feat = torch.from_numpy(rng.standard_normal((2, 3, 5, 100), dtype=np.float32))
    before = channel_moments.launches
    for a, b in zip(channel_moments(feat), channel_moments_reference(feat)):
        assert torch.equal(a, b)
    assert channel_moments.launches == before


def _state_pair(rng, count, c=8):
    mean = rng.standard_normal(c).astype(np.float32)
    m2 = (rng.random(c) * count).astype(np.float32)
    j = jw.WelfordState(jnp.float32(count), jnp.asarray(mean), jnp.asarray(m2))
    t = tw.WelfordState(torch.tensor(float(count)), torch.from_numpy(mean), torch.from_numpy(m2))
    return j, t


@pytest.mark.parametrize("counts", [(10, 30), (0, 12), (12, 0), (0, 0)])
def test_welford_merge_and_finalize_match_jax(rng, counts):
    ja, ta = _state_pair(rng, counts[0])
    jb, tb = _state_pair(rng, counts[1])
    jm, tm = jw.welford_merge(ja, jb), tw.welford_merge(ta, tb)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(tw.welford_finalize(tm), jw.welford_finalize(jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_welford_update_streams_like_jax(rng):
    js, ts = jw.welford_init(16), tw.welford_init(16)
    for n in (2, 3, 1):
        feat = (rng.standard_normal((n, 4, 4, 16), dtype=np.float32) * 2 + 5)
        js = jw.welford_update(js, jnp.asarray(feat))
        ts = tw.welford_update(ts, torch.from_numpy(feat))
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_make_bank_step_masks_padding_like_jax(rng):
    from ccst_tpu.models import vgg as jvgg
    from ccst_tpu.pipeline.style_bank import make_bank_step as jax_step
    from ccst_tpu_torch.pipeline.style_bank import make_bank_step as torch_step

    enc = jvgg.init_params(jax.random.PRNGKey(42), jvgg.ENCODER_ARCH)
    enc_np = jax.tree.map(np.asarray, enc)
    images = rng.random((3, 16, 16, 3), dtype=np.float32)
    js = jax_step(enc, dtype=jnp.float32)(jw.welford_init(512), jnp.asarray(images),
                                          jnp.asarray(2))
    ts = torch_step(enc_np, dtype=torch.float32)(tw.welford_init(512),
                                                 torch.from_numpy(images), 2)
    assert float(ts.count) == float(js.count) == 2 * 2 * 2  # valid * H/8 * W/8
    np.testing.assert_allclose(ts.mean.numpy(), np.asarray(js.mean), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ts.m2.numpy(), np.asarray(js.m2), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize(
    "feat,error",
    [
        (torch.empty((1, 4, 4, 8), dtype=torch.float16, device="meta"), TypeError),
        (torch.empty((1, 4, 8, 4), device="meta").permute(0, 1, 3, 2), ValueError),
        (torch.empty((0, 4, 4, 8), device="meta"), ValueError),
    ],
    ids=["f16", "strided", "empty"],
)
def test_channel_moments_rejects_what_the_kernel_does_not_take(feat, error):
    """A meta tensor carries shape and dtype without a card: the checks the
    CUDA path makes before it launches run on it here."""
    before = channel_moments.launches
    with pytest.raises(error):
        channel_moments(feat)
    assert channel_moments.launches == before


@pytest.mark.parametrize(
    "rows,c,itemsize,plan",
    [
        (3 * 64 * 64, 512, 2, MomentsPlan(512, 24, 8)),     # the bank's batch of 3 at 512 px
        (3 * 64 * 64, 512, 4, MomentsPlan(512, 24, 16)),
        (4 * 64 * 64, 512, 2, MomentsPlan(512, 32, 8)),     # the smoke's batch of 4
        (3 * 64 * 64, 500, 2, MomentsPlan(512, 24, 8)),
        (32 * 64 * 64, 512, 2, MomentsPlan(512, 256, 8)),   # batch 32
        (2 * 7 * 9, 100, 4, MomentsPlan(512, 1, 4)),        # one chunk: the block merges alone
        (1, 16, 4, MomentsPlan(512, 1, 1)),
    ],
)
def test_plan_moments(rows, c, itemsize, plan):
    assert plan_moments(rows, c, itemsize) == plan
    assert plan.chunk * plan.nchunks >= rows > plan.chunk * (plan.nchunks - 1)


# ragged shapes for the model of the kernel's partition: channels off the
# 128-byte group, one row, rows off the chunk and the 32-row sweep, fewer
# chunks than merge segments (3), and enough chunks (77) for uneven segments
MODEL_SHAPES = [(1, 4, 5, 500), (1, 1, 1, 16), (2, 37, 53, 12), (3, 20, 21, 40), (77 * 512 - 5, 8)]


@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_partition_model_equals_plain_version(rng, shape):
    """Chunks of rows, each chunk's mean and centred squares from block sums
    in the kernel's order, the chunks Chan-merged in chunk order: within the
    kernel's bar of the plain version, and the same bits on a second run."""
    feat = (rng.standard_normal(shape, dtype=np.float32) * 3 + 10).astype(np.float32)
    mean, m2, count = simulate_moments(feat)
    r_mean, r_m2, r_count = channel_moments_reference(torch.from_numpy(feat))
    assert count == float(r_count) == np.prod(shape[:-1])
    assert mean.dtype == m2.dtype == np.float32
    np.testing.assert_allclose(mean, r_mean.numpy(), rtol=1e-5)
    np.testing.assert_allclose(m2, r_m2.numpy(), rtol=1e-4, atol=1e-6)
    again = simulate_moments(feat.copy())
    assert mean.tobytes() == again[0].tobytes() and m2.tobytes() == again[1].tobytes()


def test_partition_model_matches_pallas_moments(rng):
    feat = (rng.standard_normal((3, 8, 8, 128), dtype=np.float32) * 3 + 10).astype(np.float32)
    m_j, m2_j, n_j = jax_channel_moments(jnp.asarray(feat), interpret=True)
    mean, m2, count = simulate_moments(feat)
    np.testing.assert_allclose(mean, np.asarray(m_j), rtol=1e-5)
    np.testing.assert_allclose(m2, np.asarray(m2_j), rtol=1e-4)
    assert count == float(n_j)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_channel_moments_on_a_device_tensor_reaches_the_build(monkeypatch, dtype):
    """What the kernel takes passes every check and asks for the kernel
    library: there is no other path for a tensor that is not on the CPU."""
    from ccst_tpu_torch.kernels import _build

    class Reached(Exception):
        pass

    def library():
        raise Reached

    monkeypatch.setattr(_build, "library", library)
    before = channel_moments.launches
    with pytest.raises(Reached):
        channel_moments(torch.empty((3, 4, 4, 500), dtype=dtype, device="meta"))
    assert channel_moments.launches == before
