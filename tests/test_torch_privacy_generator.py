"""The port's style inverter (``privacy/generator.py``) against
``ccst_tpu.privacy.generator`` on the same flax-initialized parameters,
carried across by ``from_flax``.

Tolerance 1e-5 absolute on the [0, 1] output (float32, the same maths, sums
in another order). Held: the whole ``StyleInverter`` at 64 px with
``attn_res=(32,)`` (attention and an SLE gate from the 4x4 map) and at 32 px
without; ``LinearAttention`` alone, whose 3x3-window path reads
``F.unfold``'s (N, C*9, L) features as ``conv_general_dilated_patches``'
channel-major-then-window ones; the name-for-name mapping both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.privacy import generator as jgen
from ccst_tpu_torch.privacy import generator as tgen
from tests.torch_parity import one_torch_thread  # noqa: F401



def _init(module, *args):
    """flax's init, jitted (eager flax dispatches op by op)."""
    params = jax.jit(lambda k, *a: module.init(k, *a)["params"])(jax.random.PRNGKey(0), *args)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("size,attn", [(64, (32,)), (32, ())], ids=["64px-attn32-sle", "32px"])
def test_style_inverter_matches_flax(size, attn):
    latent = 48
    jm = jgen.StyleInverter(image_size=size, latent_dim=latent, fmap_max=64, attn_res=attn)
    params = _init(jm, jnp.zeros((1, latent)))
    tm = tgen.StyleInverter(size, latent, 64, attn)
    tm.load_state_dict(tgen.from_flax(params))
    z = np.random.default_rng(0).normal(size=(3, latent)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: jm.apply({"params": p}, z))(params, jnp.asarray(z)))
    with torch.no_grad():
        got = tm(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (3, size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if size == 64:
        assert any(k.startswith("SLE_0.") for k in tm.state_dict())
        assert any(k.startswith("attn_32.") for k in tm.state_dict())


def test_linear_attention_window_order():
    c = 8
    jm = jgen.LinearAttention(dim_head=4, heads=2)
    x = np.random.default_rng(1).normal(size=(2, 5, 6, c)).astype(np.float32)
    params = _init(jm, jnp.asarray(x))
    tm = tgen.LinearAttention(c, dim_head=4, heads=2)
    tm.load_state_dict(tgen.from_flax(params))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_flax_tree_round_trip_and_init():
    jm = jgen.StyleInverter(image_size=64, latent_dim=16, fmap_max=32, attn_res=(32,))
    params = _init(jm, jnp.zeros((1, 16)))
    tm = tgen.StyleInverter(64, 16, 32, (32,), generator=torch.Generator().manual_seed(0))
    assert sorted(tgen.from_flax(params)) == sorted(tm.state_dict())
    back = tgen.to_flax(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.shape == b.shape
    # flax's lecun_normal: truncated at 2 std, variance 1 / fan_in; zero biases
    w = tm.GLUConv_0.Conv_0.weight.detach()
    std = (1.0 / (9 * w.shape[1])) ** 0.5
    assert float(w.abs().max()) <= 2 * std / 0.87962566 + 1e-6
    assert abs(float(w.std()) / std - 1) < 0.1
    assert float(tm.GLUConv_0.Conv_0.bias.detach().abs().max()) == 0.0
    with pytest.raises(ValueError, match="power of 2"):
        tgen.StyleInverter(48)
