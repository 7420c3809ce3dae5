"""Adaptive instance normalization (AdaIN) ops on NHWC tensors.

Port of ``ccst_tpu/ops/adain.py``: per-(N, C) spatial statistics in float32,
unbiased (``ddof=1``) variance by default, eps added to the variance before the
square root (reference style_transfer/AdaIN/function.py:4-33). The stylize
path runs the fused kernel (``kernels/adain.py``); these are the unfused ops.
"""
from __future__ import annotations

from typing import Tuple

import torch


def calc_mean_std(
    feat: torch.Tensor, eps: float = 1e-5, ddof: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(N, C) spatial mean and std of an NHWC feature map, each
    (N, 1, 1, C) float32."""
    if feat.ndim != 4:
        raise ValueError(f"expected NHWC feature map, got shape {tuple(feat.shape)}")
    x = feat.float()
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, correction=ddof)
    return mean, torch.sqrt(var + eps)


def adain_from_stats(
    content_feat: torch.Tensor, style_mean, style_std, eps: float = 1e-5
) -> torch.Tensor:
    """AdaIN with given style statistics, broadcastable to (N, 1, 1, C).
    Returns the dtype of ``content_feat``."""
    c_mean, c_std = calc_mean_std(content_feat, eps=eps)
    x = content_feat.float()
    dev = content_feat.device
    style_mean = torch.as_tensor(style_mean, dtype=torch.float32, device=dev)
    style_std = torch.as_tensor(style_std, dtype=torch.float32, device=dev)
    normalized = (x - c_mean) / c_std
    return (normalized * style_std + style_mean).to(content_feat.dtype)


def adain(content_feat: torch.Tensor, style_feat: torch.Tensor, eps: float = 1e-5):
    """Restyle content features with the statistics of style features."""
    s_mean, s_std = calc_mean_std(style_feat, eps=eps)
    return adain_from_stats(content_feat, s_mean, s_std, eps=eps)


def alpha_blend(stylized: torch.Tensor, content: torch.Tensor, alpha) -> torch.Tensor:
    """``alpha * stylized + (1 - alpha) * content`` in the dtype of ``stylized``."""
    a = torch.as_tensor(alpha, dtype=stylized.dtype, device=stylized.device)
    return stylized * a + content * (1 - a)
