"""Adaptive instance normalization (AdaIN) ops on NHWC tensors.

Port of ``ccst_tpu/ops/adain.py``: per-(N, C) spatial statistics in float32,
unbiased (``ddof=1``) variance by default, eps added to the variance before the
square root (reference style_transfer/AdaIN/function.py:4-33). float64 inputs
(the training checks' reference) stay float64. The stylize
path runs the fused kernel (``kernels/adain.py``); these are the unfused ops.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _stat_dtype(t: torch.Tensor) -> torch.dtype:
    """float32, or float64 for a float64 input."""
    return torch.promote_types(t.dtype, torch.float32)


def calc_mean_std(
    feat: torch.Tensor, eps: float = 1e-5, ddof: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(N, C) spatial mean and std of an NHWC feature map, each
    (N, 1, 1, C) float32 (float64 for a float64 map)."""
    if feat.ndim != 4:
        raise ValueError(f"expected NHWC feature map, got shape {tuple(feat.shape)}")
    x = feat.to(_stat_dtype(feat))
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, correction=ddof)
    return mean, torch.sqrt(var + eps)


def adain_from_stats(
    content_feat: torch.Tensor, style_mean, style_std, eps: float = 1e-5
) -> torch.Tensor:
    """AdaIN with given style statistics, broadcastable to (N, 1, 1, C).
    Returns the dtype of ``content_feat``."""
    c_mean, c_std = calc_mean_std(content_feat, eps=eps)
    dtype, dev = _stat_dtype(content_feat), content_feat.device
    x = content_feat.to(dtype)
    style_mean = torch.as_tensor(style_mean, dtype=dtype, device=dev)
    style_std = torch.as_tensor(style_std, dtype=dtype, device=dev)
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


# ---------------------------------------------------------------------------
# CORAL color transfer (reference function.py:36-77). HWC layout, C == 3.
# ---------------------------------------------------------------------------


def _flatten_mean_std(feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W, 3) image -> per-channel flattened values (3, H*W), mean and
    unbiased (``ddof=1``) std, float32."""
    if feat.ndim != 3 or feat.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {tuple(feat.shape)}")
    flat = feat.float().reshape(-1, 3).T
    return flat, flat.mean(dim=-1, keepdim=True), flat.std(dim=-1, keepdim=True, correction=1)


def _mat_sqrt(x: torch.Tensor) -> torch.Tensor:
    u, d, vt = torch.linalg.svd(x)
    return (u * torch.sqrt(d)[None, :]) @ vt


def coral(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Second-order (covariance) color alignment of ``source`` onto ``target``,
    both (H, W, 3) images, in float32: channels standardized, whitened by the
    inverse matrix square root of the source correlation (+ I), re-colored by
    the target's, rescaled to the target's per-channel moments
    (function.py:51-77). Returns the dtype of ``source``."""
    eye = torch.eye(3, dtype=torch.float32, device=source.device)
    s_flat, s_mean, s_std = _flatten_mean_std(source)
    s_norm = (s_flat - s_mean) / s_std
    s_cov_eye = s_norm @ s_norm.T + eye
    t_flat, t_mean, t_std = _flatten_mean_std(target)
    t_norm = (t_flat - t_mean) / t_std
    t_cov_eye = t_norm @ t_norm.T + eye
    transfer = _mat_sqrt(t_cov_eye) @ (torch.linalg.inv(_mat_sqrt(s_cov_eye)) @ s_norm)
    out = transfer * t_std + t_mean  # (3, H*W)
    return out.T.reshape(source.shape).to(source.dtype)
