"""K1/K2's plain versions (ccst_tpu_torch.kernels.level1) held against the JAX
Pallas kernels ccst_tpu.kernels.level1_pallas.encoder_level1 /
decoder_level1 in interpret mode, and against the JAX unfused _qconv_s chain
at a packed height the Pallas row-tile rule rejects. Every comparison is bit
for bit. The weights are the JAX package's own int8-static preparation of
PRNGKey(0/1) weights with uniform scales, as tests/test_kernels.py builds
them.

The redesigned K1 runs only on the card, so its addressing is held here
through the numpy model ``level1.simulate_encoder_level1`` (clamped input
tile, im2col rows around the clamped halo pixel, the intermediate in the conv
core's planes, taps as start slots, the permuted output columns and the phase
max over one thread's registers): exactly the plain version's result at ragged
sizes, and exactly the Pallas kernel's. Likewise K2 through
``level1.simulate_decoder_level1`` (the input tile as planes of pitch 20,
conv1 over flat positions of that pitch, the edge-replica fix-up on border
tiles, the narrow tile's accumulator columns).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.kernels import level1_pallas as jl1
from ccst_tpu.models import vgg as jvgg
from ccst_tpu.models import vgg_fast as jf
from ccst_tpu_torch.kernels import igemm_layout, level1
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


def _random_layer(rng, cin, cout):
    """Seeded int8 weights with terms that spread the requantized output over
    0..127 (a clipped share at both ends)."""
    wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    k = (rng.uniform(0.5, 1.5, cout) * 40 / (127 * 73 * math.sqrt(9 * cin))).astype(np.float32)
    kb = (rng.standard_normal(cout) * 10).astype(np.float32)
    return make_qconv(wq, k, kb, True, True, "cpu")


def test_level1_column_order_keeps_phases_in_one_thread():
    """The order is a permutation of conv1_2's 256 phase-major columns, and the
    eight accumulator registers ``8 (4 jc + phase) + 2 t + e`` of quad lane t
    in pass p hold the four phases of channels 16 t + 8 p + 2 jc + e."""
    order = igemm_layout.level1_column_order(64, 128)
    assert sorted(order.tolist()) == list(range(256))
    for p in range(2):
        for t in range(4):
            mine = [p * 128 + 8 * j + 2 * t + e for j in range(16) for e in range(2)]
            chans = {int(order[c]) % 64 for c in mine}
            assert chans == set(range(16 * t + 8 * p, 16 * t + 8 * p + 8))
            for jc in range(4):
                for e in range(2):
                    cols = [p * 128 + igemm_layout.accumulator_column(4 * jc + ph, t, e)
                            for ph in range(4)]
                    assert [int(order[c]) for c in cols] == [
                        ph * 64 + 16 * t + 8 * p + 2 * jc + e for ph in range(4)]


def test_level1_weight_layout(rng):
    """conv1_1 packs as one GEMM chunk with k = (dy, dx, ci) padded to 128;
    conv1_2 as the conv core's stage tiles with permuted columns, its terms
    permuted alike; undoing both gives the layers back."""
    q1, q2 = _random_layer(rng, 12, 256), _random_layer(rng, 256, 256)
    lw = level1.prepare_encoder_level1(q1, q2)
    assert lw.w1p.shape == (2, 1, 1, 8, 128, 16) and lw.w2p.shape == (2, 2, 9, 8, 128, 16)
    assert lw.w1p.is_contiguous() and lw.w2p.is_contiguous()
    flat = lw.w1p[:, 0, 0].permute(1, 3, 0, 2).reshape(128, 256)   # (k, column)
    assert torch.equal(flat[:108], q1.wq.reshape(108, 256)) and not flat[108:].any()
    order = torch.from_numpy(igemm_layout.level1_column_order(64, 128))
    w2 = igemm_layout.unpack_stage_tiles(lw.w2p, 256, 256)
    assert torch.equal(w2, q2.wq[..., order])
    inverse = torch.argsort(order)
    assert torch.equal(w2[..., inverse], q2.wq)
    assert torch.equal(lw.k2p[inverse], q2.k) and torch.equal(lw.kb2p[inverse], q2.kb)


# one row; below one tile each way; 18 rows; several tiles with both edges
# ragged; exactly one tile; one column of tiles
@pytest.mark.parametrize("shape", [(1, 1, 3), (2, 7, 33), (1, 18, 10), (2, 19, 37), (1, 8, 16),
                                   (1, 50, 6)], ids=lambda s: "x".join(map(str, s)))
def test_simulated_encoder_matches_plain_version(rng, shape):
    q1, q2 = _random_layer(rng, 12, 256), _random_layer(rng, 256, 256)
    lw = level1.prepare_encoder_level1(q1, q2)
    x = rng.integers(-127, 128, (*shape, 12)).astype(np.int8)
    want = level1.encoder_level1_reference(torch.from_numpy(x), q1, q2).numpy()
    assert len(np.unique(want)) > 20  # the outputs spread, so equality says something
    np.testing.assert_array_equal(level1.simulate_encoder_level1(x, q1, lw), want)


def test_simulated_encoder_matches_pallas(rng, q8s):
    eq, _, tq, _ = q8s
    x = rng.integers(-127, 128, (2, 16, 16, 12)).astype(np.int8)
    ref = jl1.encoder_level1(jnp.asarray(x), eq["conv1_1"], eq["conv1_2"], ht=8, interpret=True)
    lw = level1.prepare_encoder_level1(tq["conv1_1"], tq["conv1_2"])
    np.testing.assert_array_equal(level1.simulate_encoder_level1(x, tq["conv1_1"], lw),
                                  np.asarray(ref))


def test_decoder_level1_weight_layout(rng):
    """dconv1_2 packs as 64-byte stage tiles (two 128-column tiles, nine taps,
    four 16-byte groups: no zero half), the three taps of a kernel row of one
    column half one contiguous 24 KB run; dconv1_1 as K0's narrow stage tiles;
    undoing both gives the layers back."""
    q2 = _random_layer(rng, 64, 256)
    q1 = make_qconv(rng.integers(-127, 128, (3, 3, 256, 12)).astype(np.int8),
                    np.ones(12, np.float32), np.zeros(12, np.float32), True, False, "cpu")
    dw = level1.prepare_decoder_level1(q2, q1)
    assert dw.w1p.shape == (2, 1, 9, 4, 128, 16) and dw.w1p.is_contiguous()
    assert dw.w2p.shape == (1, 2, 9, 8, 16, 16) and dw.w2p.is_contiguous()
    assert torch.equal(igemm_layout.unpack_stage_tiles(dw.w1p, 64, 256), q2.wq)
    assert torch.equal(igemm_layout.unpack_stage_tiles(dw.w2p, 256, 12), q1.wq)
    assert dw.w2p is q1.wp  # K0's own layout for Cout <= 16, not packed twice
    # stage (column half h, kernel row dy) starts 3 h + dy runs of 24 KB into the array
    flat = dw.w1p.reshape(-1)
    stage = 3 * 128 * 64
    h, dy, dx, grp, n, b = 1, 2, 1, 3, 77, 5
    at = (3 * h + dy) * stage + dx * 128 * 64 + grp * 128 * 16 + n * 16 + b
    assert flat[at] == q2.wq[dy, dx, 16 * grp + b, 128 * h + n]


# the encoder's ragged planes, then planes that put a tile border on every side
# of the edge-replica fix-up: exact tiles, one past a tile each way, 2 x 2
@pytest.mark.parametrize("shape", [(1, 1, 3), (2, 7, 33), (1, 18, 10), (2, 19, 37), (1, 8, 16),
                                   (1, 50, 6), (1, 9, 17), (2, 16, 32), (1, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_simulated_decoder_matches_plain_version(rng, shape):
    q2 = _random_layer(rng, 64, 256)
    wq1 = rng.integers(-127, 128, (3, 3, 256, 12)).astype(np.int8)
    k1 = (rng.uniform(0.5, 1.5, 12) / (127 * 73 * math.sqrt(9 * 256))).astype(np.float32)
    q1 = make_qconv(wq1, k1, rng.standard_normal(12).astype(np.float32), True, False, "cpu")
    dw = level1.prepare_decoder_level1(q2, q1)
    y = rng.integers(-127, 128, (*shape, 64)).astype(np.int8)
    want = level1.decoder_level1_reference(torch.from_numpy(y), q2, q1, torch.bfloat16)
    assert len(torch.unique(want)) > 20  # the outputs spread, so equality says something
    got = level1.simulate_decoder_level1(y, q2, q1, dw)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_simulated_decoder_matches_pallas(rng, q8s):
    _, dq, _, tq = q8s
    y = rng.integers(-127, 128, (2, 16, 16, 64)).astype(np.int8)
    ref = jl1.decoder_level1(jnp.asarray(y), dq["dconv1_2"], dq["dconv1_1"], ht=8,
                             interpret=True)
    dw = level1.prepare_decoder_level1(tq["dconv1_2"], tq["dconv1_1"])
    got = level1.simulate_decoder_level1(y, tq["dconv1_2"], tq["dconv1_1"], dw)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_decoder_wrapper_takes_prepared_weights(rng, q8s):
    """The engine packs K2's weights once; on the CPU the wrapper ignores them
    and runs the plain version."""
    _, _, _, tq = q8s
    dw = level1.prepare_decoder_level1(tq["dconv1_2"], tq["dconv1_1"])
    y = torch.from_numpy(rng.integers(-127, 128, (1, 5, 9, 64)).astype(np.int8))
    assert torch.equal(
        level1.decoder_level1(y, tq["dconv1_2"], tq["dconv1_1"], torch.bfloat16, dw),
        level1.decoder_level1(y, tq["dconv1_2"], tq["dconv1_1"]))


def test_encoder_wrapper_takes_prepared_weights(rng):
    """The engine packs K1's weights once; on the CPU the wrapper ignores them
    and runs the plain version."""
    q1, q2 = _random_layer(rng, 12, 256), _random_layer(rng, 256, 256)
    lw = level1.prepare_encoder_level1(q1, q2)
    x = torch.from_numpy(rng.integers(-127, 128, (1, 5, 9, 12)).astype(np.int8))
    assert torch.equal(level1.encoder_level1(x, q1, q2, lw), level1.encoder_level1(x, q1, q2))


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
