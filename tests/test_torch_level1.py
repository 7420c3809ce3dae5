"""K1/K2's plain versions (ccst_tpu_torch.kernels.level1) held against the JAX
Pallas kernels ccst_tpu.kernels.level1_pallas.encoder_level1 /
decoder_level1 in interpret mode, and against the JAX unfused _qconv_s chain
at a packed height the Pallas row-tile rule rejects. Every comparison is bit
for bit. The weights are the JAX package's own int8-static preparation of
PRNGKey(0/1) weights with uniform scales, as tests/test_kernels.py builds
them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.kernels import level1_pallas as jl1
from ccst_tpu.models import vgg as jvgg
from ccst_tpu.models import vgg_fast as jf
from ccst_tpu_torch.kernels import level1
from ccst_tpu_torch.kernels.qconv import make_qconv


@pytest.fixture(scope="module")
def q8s():
    enc = jvgg.init_params(jax.random.PRNGKey(0), jvgg.ENCODER_ARCH, dtype=jnp.bfloat16)
    dec = jvgg.init_params(jax.random.PRNGKey(1), jvgg.DECODER_ARCH, dtype=jnp.bfloat16)
    scales = {k: 4.0 for k in list(jf._ENC_NEXT) + list(jf._DEC_NEXT)}
    eq = jf.prepare_encoder_q8s(enc, scales)
    dq = jf.prepare_decoder_q8s(dec, scales)

    def port(q):
        return make_qconv(np.asarray(q.wq), np.asarray(q.k), np.asarray(q.kb),
                          q.packed, q.requant, "cpu")

    return eq, dq, {n: port(eq[n]) for n in ("conv1_1", "conv1_2")}, {
        n: port(dq[n]) for n in ("dconv1_2", "dconv1_1")
    }


def test_encoder_level1_matches_pallas(rng, q8s):
    eq, _, tq, _ = q8s
    x = rng.integers(-127, 128, (2, 16, 16, 12)).astype(np.int8)
    ref = jl1.encoder_level1(jnp.asarray(x), eq["conv1_1"], eq["conv1_2"], ht=8, interpret=True)
    got = level1.encoder_level1(torch.from_numpy(x), tq["conv1_1"], tq["conv1_2"])
    assert got.dtype == torch.int8 and got.shape == (2, 16, 16, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_decoder_level1_matches_pallas(rng, q8s):
    _, dq, _, tq = q8s
    y = rng.integers(-127, 128, (2, 16, 16, 64)).astype(np.int8)
    ref = jl1.decoder_level1(jnp.asarray(y), dq["dconv1_2"], dq["dconv1_1"], ht=8,
                             interpret=True)
    got = level1.decoder_level1(torch.from_numpy(y), tq["dconv1_2"], tq["dconv1_1"])
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 16, 12)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("which", ["encoder", "decoder"])
def test_level1_at_heights_the_pallas_rule_rejects(rng, q8s, which):
    """18 packed rows (36 px images): no row tile of 8 or 16 divides it, so
    ccst_tpu falls back to the unfused chain there; the port takes any
    size."""
    eq, dq, tq_enc, tq_dec = q8s
    if which == "encoder":
        x = rng.integers(-127, 128, (1, 18, 10, 12)).astype(np.int8)
        ref = jf._qconv_s(jnp.asarray(x), eq["conv1_1"], True, jnp.bfloat16, "edge")
        ref = jf._qconv_s(ref, eq["conv1_2"], True, jnp.bfloat16, "edge")
        ref = jf.phase_max(ref, 64)
        got = level1.encoder_level1(torch.from_numpy(x), tq_enc["conv1_1"], tq_enc["conv1_2"])
    else:
        x = rng.integers(-127, 128, (1, 18, 10, 64)).astype(np.int8)
        ref = jf._qconv_s(jnp.asarray(x), dq["dconv1_2"], True, jnp.bfloat16, "edge")
        ref = jf._qconv_s(ref, dq["dconv1_1"], False, jnp.bfloat16, "edge")
        got = level1.decoder_level1(torch.from_numpy(x), tq_dec["dconv1_2"], tq_dec["dconv1_1"])
    assert jf._pick_ht(18, 16) is None
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def _meta_layer(cin, cout, requant):
    return make_qconv(np.zeros((3, 3, cin, cout), np.int8), np.ones(cout, np.float32),
                      np.zeros(cout, np.float32), True, requant, "meta")


@pytest.mark.parametrize(
    "call",
    [
        # K1 takes the packed 12-channel input and two requantizing layers
        lambda: level1.encoder_level1(torch.empty((1, 8, 8, 16), dtype=torch.int8, device="meta"),
                                      _meta_layer(16, 256, True), _meta_layer(256, 256, True)),
        lambda: level1.encoder_level1(torch.empty((1, 8, 8, 12), dtype=torch.int8, device="meta"),
                                      _meta_layer(12, 256, True), _meta_layer(256, 256, False)),
        # K2 writes at most 16 even output channels, in bf16
        lambda: level1.decoder_level1(torch.empty((1, 8, 8, 64), dtype=torch.int8, device="meta"),
                                      _meta_layer(64, 256, True), _meta_layer(256, 24, False)),
        lambda: level1.decoder_level1(torch.empty((1, 8, 8, 64), dtype=torch.int8, device="meta"),
                                      _meta_layer(64, 256, True), _meta_layer(256, 12, False),
                                      torch.float32),
    ],
    ids=["k1-cin", "k1-dequant", "k2-cout", "k2-f32"],
)
def test_wrappers_reject_what_the_kernel_does_not_take(call):
    before = (level1.encoder_level1.launches, level1.decoder_level1.launches)
    with pytest.raises((ValueError, TypeError)):
        call()
    assert (level1.encoder_level1.launches, level1.decoder_level1.launches) == before
