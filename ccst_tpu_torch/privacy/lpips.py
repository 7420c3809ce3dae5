"""LPIPS (Learned Perceptual Image Patch Similarity), v0.1 with a VGG16 trunk.

Port of ``ccst_tpu/privacy/lpips.py``. The reference scores reconstructions
with ``lpips.LPIPS(net='vgg')`` (reconstruct_img/test.py:28,184): inputs from
[0, 1] to [-1, 1] and through the fixed shift / scale, torchvision VGG16's
features at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, each position's
channel vector unit-normalized (eps outside the sqrt), the squared difference
weighted by a non-negative per-channel head, spatial mean, sum over taps.

VGG16 pads with zeros and pools 2x2 with floor: these are plain
``F.conv2d`` / ``F.max_pool2d`` in float32, not K3 (which reflect-pads; no TPU
kernel computes them). Weights come as torch checkpoint files
(``--lpips-vgg`` / ``--lpips-lin`` on ``invert-eval``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

# VGG16 conv plan: (torchvision features index, out_channels); 'M' = maxpool.
VGG16_PLAN: Sequence = (
    (0, 64), (2, 64), "M",
    (5, 128), (7, 128), "M",
    (10, 256), (12, 256), (14, 256), "M",
    (17, 512), (19, 512), (21, 512), "M",
    (24, 512), (26, 512), (28, 512),
)
TAP_AFTER = (2, 7, 14, 21, 28)  # relu1_2, 2_2, 3_3, 4_3, 5_3
TAP_CHANNELS = (64, 128, 256, 512, 512)

# fixed input scaling (lpips.ScalingLayer constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(v).detach().float().cpu().clone()


def convert_vgg16_features(state_dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """torchvision ``vgg16.features`` state dict (keys ``features.N.weight``
    or bare ``N.weight``) -> ``{convN: {w (OIHW), b}}`` float32."""
    params = {}
    for item in VGG16_PLAN:
        if item == "M":
            continue
        idx, _ = item
        for prefix in (f"features.{idx}", str(idx)):
            wk, bk = f"{prefix}.weight", f"{prefix}.bias"
            if wk in state_dict:
                params[f"conv{idx}"] = {"w": _tensor(state_dict[wk]), "b": _tensor(state_dict[bk])}
                break
        else:
            raise KeyError(f"missing VGG16 conv {idx} in state dict")
    return params


def convert_lin_heads(state_dict) -> List[torch.Tensor]:
    """LPIPS linear-head state dict (keys ``lin{i}.model.1.weight``,
    (1, C, 1, 1)) -> list of (C,) non-negative weight vectors."""
    lins = []
    for i, c in enumerate(TAP_CHANNELS):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in state_dict:
                w = _tensor(state_dict[key]).reshape(-1)
                if w.shape[0] != c:
                    raise ValueError(f"lin{i}: {w.shape[0]} != {c}")
                lins.append(w)
                break
        else:
            raise KeyError(f"missing lin{i} in LPIPS head state dict")
    return lins


def load_lpips_weights(vgg16_path: str, lin_path: str):
    """Load torch checkpoint FILES (torchvision vgg16 + LPIPS lin heads)."""
    vgg_sd = torch.load(vgg16_path, map_location="cpu", weights_only=True)
    lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
    return convert_vgg16_features(vgg_sd), convert_lin_heads(lin_sd)


def to_device(vgg_params, lins, device):
    return ({k: {n: t.to(device) for n, t in p.items()} for k, p in vgg_params.items()},
            [w.to(device) for w in lins])


def _vgg16_taps(params, x: torch.Tensor) -> List[torch.Tensor]:
    """NCHW input (already LPIPS-scaled) -> the five tap activations (NCHW)."""
    taps = []
    for item in VGG16_PLAN:
        if item == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        idx, _ = item
        p = params[f"conv{idx}"]
        x = torch.relu(F.conv2d(x, p["w"], p["b"], padding=1))
        if idx in TAP_AFTER:
            taps.append(x)
    return taps


def lpips_distance(vgg_params, lins, a: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-10) -> torch.Tensor:
    """LPIPS(a, b) per batch element; a / b are NHWC in [0, 1] (converted to
    the [-1, 1] + ScalingLayer domain inside, lpips's ``im2tensor``
    convention). Weights on the inputs' device."""
    shift = torch.tensor(_SHIFT, device=a.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=a.device).view(1, 3, 1, 1)

    def prep(x):
        x = x.float().permute(0, 3, 1, 2) * 2.0 - 1.0
        return (x - shift) / scale

    total = 0.0
    for ta, tb, lin in zip(_vgg16_taps(vgg_params, prep(a)), _vgg16_taps(vgg_params, prep(b)),
                           lins):
        # lpips.normalize_tensor: x / (||x||_2 + eps), eps OUTSIDE the sqrt
        na = ta / (torch.sqrt(torch.sum(ta * ta, dim=1, keepdim=True)) + eps)
        nb = tb / (torch.sqrt(torch.sum(tb * tb, dim=1, keepdim=True)) + eps)
        d2 = (na - nb) ** 2
        # the 1x1 conv with a (C,) non-negative weight is a channel dot
        total = total + torch.mean(torch.sum(d2 * lin.view(1, -1, 1, 1), dim=1), dim=(1, 2))
    return total
