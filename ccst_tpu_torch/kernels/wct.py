"""WCT's centring pass: CUDA kernel wrapper and plain version.

Replaces no TPU kernel (the JAX package has no WCT): ``csrc/wct/wct_centre.cu``
takes a batch of content features (B, P, C) and their per-image channel means
and writes the operands of the transform's two products in one pass:

- ``hi`` (B, P, C + 8): ``d = x - mean`` rounded to the compute dtype, then
  the columns 1, 1, 0 x 6, so that ``hi @ [T^T; m_hi; m_lo; 0..]`` applies a
  matrix and adds a float32 mean in the product's float32 sums;
- ``lo`` (B, P, C), bfloat16 only: ``d - hi`` rounded to bfloat16, so that
  ``hi^T hi + hi^T lo + lo^T hi`` is the Gram of ``d`` to ~2^-16 of each entry.

The kernel is built by ``kernels/_build.py`` into a library of its own
(``library("wct")``), at the first WCT call. Its header says what bounds it on
the H100 and how the design answers that. ``centre_split.launches`` counts the
launches.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ccst_tpu_torch.kernels import refuse_autograd

PAD = 8  # the columns hi carries after C: 1, 1, then zeros


def centre_split_reference(x: torch.Tensor, mean: torch.Tensor
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version: the same float32 difference, roundings and pad."""
    b, p, c = x.shape
    d = x.float() - mean[:, None, :]
    hi = torch.zeros((b, p, c + PAD), dtype=x.dtype, device=x.device)
    hi[..., :c] = d
    hi[..., c:c + 2] = 1
    lo = (d - hi[..., :c].float()).to(torch.bfloat16) if x.dtype == torch.bfloat16 else None
    return hi, lo


def centre_split(x: torch.Tensor, mean: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, P, C) features and (B, C) float32 means -> ``(hi, lo)``; ``lo`` is
    ``None`` for float32 features."""
    refuse_autograd("wct centre_split", x, mean)
    if x.dim() != 3 or mean.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"features {tuple(x.shape)} and means {tuple(mean.shape)} do not fit")
    if x.device.type == "cpu":
        return centre_split_reference(x, mean)
    if x.dtype not in (torch.bfloat16, torch.float32) or mean.dtype != torch.float32:
        raise TypeError("the WCT centring kernel takes bfloat16 or float32 features "
                        "and float32 means")
    if not (x.is_contiguous() and mean.is_contiguous()) or x.shape[2] % PAD:
        raise ValueError("the WCT centring kernel takes contiguous tensors and C % 8 == 0")
    if mean.device != x.device:
        raise ValueError("features and means are on different devices")
    from ccst_tpu_torch.kernels import _build

    b, p, c = x.shape
    hi = torch.empty((b, p, c + PAD), dtype=x.dtype, device=x.device)
    is_f32 = x.dtype == torch.float32
    lo = None if is_f32 else torch.empty_like(x)
    if any(t.data_ptr() % 16 for t in (x, mean, hi) + (() if lo is None else (lo,))):
        raise ValueError("the WCT centring kernel needs 16-byte aligned operands")
    rc = _build.library("wct").ccst_wct_centre_split(
        x.data_ptr(), mean.data_ptr(), hi.data_ptr(), 0 if lo is None else lo.data_ptr(),
        b, p, c, int(is_f32), torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"wct centre_split launch failed: CUDA error {rc}")
    centre_split.launches += 1
    return hi, lo


centre_split.launches = 0
