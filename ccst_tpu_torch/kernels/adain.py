"""Fused AdaIN (statistics + normalize + rescale + alpha blend): Triton kernel
wrapper and plain version.

Replaces ``ccst_tpu/kernels/adain_pallas.py::fused_adain`` (K4), which computes
``adain_from_stats`` + ``alpha_blend`` of the stylize path in one pass:

    out = alpha * ((x - mu) * rsqrt(var + eps) * s_std + s_mean) + (1 - alpha) * x

with per-(n, c) spatial statistics in float32, unbiased (``ddof=1``) variance,
and one rounding to the feature dtype. The kernel is
``kernels/adain_triton.py``; its header says what bounds it on the H100 and how
the design answers that. Unlike the TPU kernel there is no ``C % 128`` rule.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

BLOCK_HW = 256
BLOCK_C = 16


def fused_adain_reference(
    feat: torch.Tensor, s_mean, s_std, alpha: float = 1.0, eps: float = 1e-5,
    ddof: int = 1,
) -> torch.Tensor:
    """Plain version, the formula of the TPU kernel in float32."""
    n, h, w, c = feat.shape
    x = feat.float()
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = torch.square(x - mean).sum(dim=(1, 2), keepdim=True) / max(h * w - ddof, 1)
    inv_std = torch.rsqrt(var + eps)
    s_mean = torch.as_tensor(s_mean, dtype=torch.float32, device=feat.device).view(c)
    s_std = torch.as_tensor(s_std, dtype=torch.float32, device=feat.device).view(c)
    stylized = (x - mean) * inv_std * s_std + s_mean
    return (alpha * stylized + (1.0 - alpha) * x).to(feat.dtype)


def fused_adain(
    feat: torch.Tensor, s_mean: torch.Tensor, s_std: torch.Tensor,
    alpha: float = 1.0, eps: float = 1e-5, ddof: int = 1,
) -> torch.Tensor:
    """AdaIN of (N, H, W, C) features to the (C,) style statistics, blended
    with the input by ``alpha``. Returns the input dtype."""
    if feat.device.type == "cpu":
        return fused_adain_reference(feat, s_mean, s_std, alpha, eps, ddof)
    n, h, w, c = feat.shape
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_adain takes bfloat16 or float32, got {feat.dtype}")
    if not feat.is_contiguous():
        raise ValueError("fused_adain takes a contiguous NHWC tensor")
    s_mean = torch.as_tensor(s_mean, dtype=torch.float32, device=feat.device).contiguous().view(c)
    s_std = torch.as_tensor(s_std, dtype=torch.float32, device=feat.device).contiguous().view(c)
    from ccst_tpu_torch.kernels.adain_triton import adain_kernel

    out = torch.empty_like(feat)
    grid = (n, (c + BLOCK_C - 1) // BLOCK_C)
    with torch.cuda.device(feat.device):
        adain_kernel[grid](
            feat, out, s_mean, s_std, float(alpha), float(eps), h * w, c,
            max(h * w - ddof, 1), BLOCK_HW=BLOCK_HW, BLOCK_C=BLOCK_C, num_warps=4,
        )
    fused_adain.launches += 1
    return out


fused_adain.launches = 0
