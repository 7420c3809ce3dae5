"""The port's LPIPS (``privacy/lpips.py``) against ``ccst_tpu.privacy.lpips``
on VGG16-features and lin-head state dicts built here (random, seeded; the
published files need the network), loaded through ``torch.save``d files on
both sides. Tolerance: 1e-5 absolute on the distance (float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccst_tpu.privacy import lpips as jlp
from ccst_tpu_torch.privacy import lpips as tlp
from tests.torch_parity import one_torch_thread  # noqa: F401



def _state_dicts(prefix_features=True):
    g = torch.Generator().manual_seed(0)
    vgg, cin = {}, 3
    for item in tlp.VGG16_PLAN:
        if item == "M":
            continue
        idx, cout = item
        key = f"features.{idx}" if prefix_features else str(idx)
        vgg[f"{key}.weight"] = torch.randn((cout, cin, 3, 3), generator=g) * (2.0 / (9 * cin)) ** 0.5
        vgg[f"{key}.bias"] = torch.randn((cout,), generator=g) * 0.01
        cin = cout
    lin = {f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=g)
           for i, c in enumerate(tlp.TAP_CHANNELS)}
    return vgg, lin


@pytest.mark.parametrize("prefix", [True, False], ids=["features.N", "N"])
def test_lpips_distance_matches_jax(tmp_path, prefix):
    vgg, lin = _state_dicts(prefix)
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lin, tmp_path / "lin.pth")
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    jv, jl = jlp.load_lpips_weights(str(tmp_path / "vgg16.pth"), str(tmp_path / "lin.pth"))
    want = np.asarray(jlp.lpips_distance(jv, jl, jnp.asarray(a), jnp.asarray(b)))
    tv, tl = tlp.load_lpips_weights(str(tmp_path / "vgg16.pth"), str(tmp_path / "lin.pth"))
    got = tlp.lpips_distance(tv, tl, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (3,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    same = tlp.lpips_distance(tv, tl, torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(same, 0.0, atol=1e-7)


def test_converters_refuse_missing_or_misshapen_entries():
    vgg, lin = _state_dicts()
    del vgg["features.28.weight"]
    with pytest.raises(KeyError, match="conv 28"):
        tlp.convert_vgg16_features(vgg)
    lin["lin0.model.1.weight"] = torch.ones((1, 3, 1, 1))
    with pytest.raises(ValueError, match="lin0"):
        tlp.convert_lin_heads(lin)
    lin.pop("lin0.model.1.weight")
    with pytest.raises(KeyError, match="lin0"):
        tlp.convert_lin_heads(lin)
