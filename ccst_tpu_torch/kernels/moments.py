"""Per-channel moments of an NHWC batch: Triton kernel wrapper and plain version.

Replaces ``ccst_tpu/kernels/welford_pallas.py::channel_moments`` (K5), the
per-batch reduction of the style-bank step: the float32 mean and M2 (sum of
squared deviations from the mean) of every channel over N*H*W, and the count.
The result is exactly what ``ops.welford.welford_merge`` consumes. The kernels
are in ``kernels/moments_triton.py``; its header says what bounds them on the
H100 and how the design answers that. There is no ``C % 128`` rule.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernels or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

BLOCK_R = 128
BLOCK_C = 16
CHUNK = 512  # rows per partial; a multiple of BLOCK_R


def channel_moments_reference(
    feat: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: two-pass float32 mean and M2 over the whole batch."""
    c = feat.shape[-1]
    x = feat.float().reshape(-1, c)
    mean = x.mean(dim=0)
    m2 = torch.square(x - mean).sum(dim=0)
    count = torch.full((), float(x.shape[0]), device=feat.device)
    return mean, m2, count


def channel_moments(feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, m2, count) in float32: (C,), (C,) and a scalar."""
    if feat.device.type == "cpu":
        return channel_moments_reference(feat)
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"channel_moments takes bfloat16 or float32, got {feat.dtype}")
    if not feat.is_contiguous():
        raise ValueError("channel_moments takes a contiguous NHWC tensor")
    c = feat.shape[-1]
    rows = feat.numel() // c
    if rows == 0:
        raise ValueError("channel_moments needs at least one row")
    from ccst_tpu_torch.kernels.moments_triton import (
        moments_merge_kernel,
        moments_partial_kernel,
    )

    n_chunks = (rows + CHUNK - 1) // CHUNK
    c_blocks = (c + BLOCK_C - 1) // BLOCK_C
    dev = feat.device
    pmean = torch.empty((n_chunks, c), dtype=torch.float32, device=dev)
    pm2 = torch.empty((n_chunks, c), dtype=torch.float32, device=dev)
    mean = torch.empty((c,), dtype=torch.float32, device=dev)
    m2 = torch.empty((c,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        moments_partial_kernel[(n_chunks, c_blocks)](
            feat, pmean, pm2, rows, c, CHUNK,
            BLOCK_R=BLOCK_R, BLOCK_C=BLOCK_C, num_warps=4,
        )
        moments_merge_kernel[(c_blocks,)](
            pmean, pm2, mean, m2, rows, c, CHUNK, n_chunks,
            BLOCK_C=BLOCK_C, num_warps=1,
        )
    channel_moments.launches += 1
    count = torch.full((), float(rows), device=dev)
    return mean, m2, count


channel_moments.launches = 0
