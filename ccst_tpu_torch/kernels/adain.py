"""Fused AdaIN (statistics + normalize + rescale + alpha blend) for one or S
style banks: CUDA kernel wrappers and plain versions.

Replaces ``ccst_tpu/kernels/adain_pallas.py::fused_adain`` (K4), which computes
``adain_from_stats`` + ``alpha_blend`` of the stylize path in one pass:

    out = alpha * ((x - mu) * rsqrt(var + eps) * s_std + s_mean) + (1 - alpha) * x

with per-(n, c) spatial statistics in float32, unbiased (``ddof=1``) variance,
and one rounding to the feature dtype. The kernel is ``csrc/adain.cu`` (built
by ``kernels/_build.py``); its header says what bounds it on the H100 and how
the design answers that. :func:`fused_adain_multi` restyles the same features
under S banks in one launch (statistics once, S outputs), as the stylize
path's ``stylize_multi`` needs; :func:`fused_adain` is its S = 1 case. Unlike
the TPU kernel there is no ``C % 128`` rule. :func:`fused_adain_given` is the
same formula with the content statistics given: the row-sharded stylize path
(``parallel/spatial.py``) merges them over its ranks first, since a rank holds
only part of each image's plane.

On a CPU tensor the wrappers compute the plain versions; on a CUDA tensor
they launch the kernel or raise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ccst_tpu_torch.kernels import refuse_autograd
from ccst_tpu_torch.kernels.resident_slice import MAX_ROWS, block_sum

TARGET_ROWS = 128  # a slice is split over more blocks while a block would hold more rows
MAX_CLUSTER = 8    # blocks of a thread block cluster at most (the portable size)


class AdainPlan(NamedTuple):
    """How the kernel splits one (image, channel group) slice of H*W rows."""

    cluster: int         # blocks that share the slice: 1, 2, 4 or 8
    rows_per_block: int  # rows of a block; the last block may hold fewer
    resident: bool       # the slice stays in shared memory (else: streamed)


def plan_adain(hw: int) -> AdainPlan:
    """The partition of a slice's ``hw`` rows (a slice is one 128-byte channel
    group wide, whatever the dtype), from the shape alone: the smallest
    cluster (a power of two up to 8) that leaves a block at most
    ``TARGET_ROWS`` rows, so that small maps still spread over the card; the
    slice is resident if a block's rows fit its shared memory (``MAX_ROWS``:
    maps up to about 119 x 119), and streamed from device memory three times
    otherwise."""
    cluster = 1
    while cluster < MAX_CLUSTER and -(-hw // cluster) > TARGET_ROWS:
        cluster *= 2
    rows = -(-hw // cluster)
    return AdainPlan(cluster, rows, rows <= MAX_ROWS)


def fused_adain_reference(
    feat: torch.Tensor, s_mean, s_std, alpha: float = 1.0, eps: float = 1e-5,
    ddof: int = 1, mean=None, inv_std=None,
) -> torch.Tensor:
    """Plain version, the formula of the TPU kernel in float32. ``mean`` and
    ``inv_std``, (N, C) float32, replace the statistics of ``feat`` when
    given (the plain version of :func:`fused_adain_given`)."""
    n, h, w, c = feat.shape
    x = feat.float()
    if mean is None:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = torch.square(x - mean).sum(dim=(1, 2), keepdim=True) / max(h * w - ddof, 1)
        inv_std = torch.rsqrt(var + eps)
    else:
        mean = mean.float().reshape(n, 1, 1, c)
        inv_std = inv_std.float().reshape(n, 1, 1, c)
    s_mean = torch.as_tensor(s_mean, dtype=torch.float32, device=feat.device).view(c)
    s_std = torch.as_tensor(s_std, dtype=torch.float32, device=feat.device).view(c)
    stylized = (x - mean) * inv_std * s_std + s_mean
    return (alpha * stylized + (1.0 - alpha) * x).to(feat.dtype)


def fused_adain_multi_reference(
    feat: torch.Tensor, s_means, s_stds, alpha: float = 1.0, eps: float = 1e-5,
    ddof: int = 1, mean=None, inv_std=None,
) -> torch.Tensor:
    """Plain version of :func:`fused_adain_multi` (with ``mean`` and
    ``inv_std``: of :func:`fused_adain_given`): the plain single-style
    version once per bank, stacked to (S, N, H, W, C)."""
    return torch.stack([
        fused_adain_reference(feat, m, s, alpha, eps, ddof, mean, inv_std)
        for m, s in zip(s_means, s_stds)
    ])


def simulate_adain(
    feat: np.ndarray, s_means: np.ndarray, s_stds: np.ndarray, alpha: float = 1.0,
    eps: float = 1e-5, ddof: int = 1,
) -> np.ndarray:
    """Numpy model of the kernel's partition on float32 (N, H, W, C) features:
    the rows of a slice over the cluster's blocks (:func:`plan_adain`), each
    block's sum in the kernel's order (``resident_slice.block_sum``), the
    partials added in rank order, first the sums and then the centred
    squares. Returns float32 (S, N, H, W, C), without the final rounding."""
    n, h, w, c = feat.shape
    hw = h * w
    plan = plan_adain(hw)
    x = np.asarray(feat, np.float32).reshape(n, hw, c)
    blocks = [slice(r * plan.rows_per_block, min((r + 1) * plan.rows_per_block, hw))
              for r in range(plan.cluster)]

    def cluster_total(values):
        total = np.zeros((n, c), np.float32)
        for rows in blocks:  # rank order
            total += block_sum(values[:, rows])
        return total

    mean = cluster_total(x) / np.float32(hw)
    sq = cluster_total(np.square(x - mean[:, None]))
    inv = np.float32(1.0) / np.sqrt(sq / np.float32(max(hw - ddof, 1)) + np.float32(eps))
    a, b = np.float32(alpha), np.float32(1.0) - np.float32(alpha)
    outs = [a * ((x - mean[:, None]) * inv[:, None] * np.float32(s) + np.float32(m)) + b * x
            for m, s in zip(np.asarray(s_means, np.float32), np.asarray(s_stds, np.float32))]
    return np.stack(outs).reshape(len(outs), n, h, w, c)


def fused_adain_multi(
    feat: torch.Tensor, s_means: torch.Tensor, s_stds: torch.Tensor,
    alpha: float = 1.0, eps: float = 1e-5, ddof: int = 1,
) -> torch.Tensor:
    """AdaIN of (N, H, W, C) features to each of the S rows of the (S, C) style
    statistics, blended with the input by ``alpha``: (S, N, H, W, C) in the
    input dtype, from one kernel launch that computes the content statistics
    once. Which variant of the kernel runs follows from the shape alone
    (:func:`plan_adain`): the slice resident in the shared memory of a cluster
    of blocks for maps up to about 119 x 119, streamed above. Raises if an
    input requires grad under grad mode: the kernel has no backward."""
    refuse_autograd("fused_adain", feat, s_means, s_stds)
    if feat.device.type == "cpu":
        return fused_adain_multi_reference(feat, s_means, s_stds, alpha, eps, ddof)
    n, h, w, c = feat.shape
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_adain takes bfloat16 or float32, got {feat.dtype}")
    if not feat.is_contiguous():
        raise ValueError("fused_adain takes a contiguous NHWC tensor")
    if feat.numel() == 0:
        raise ValueError("fused_adain needs at least one element")
    s_means, s_stds = _style_rows(s_means, s_stds, c, feat.device)
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    s = s_means.shape[0]
    plan = plan_adain(h * w)
    out = torch.empty((s, n, h, w, c), dtype=feat.dtype, device=feat.device)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = lib.ccst_adain(
            feat.data_ptr(), out.data_ptr(), s_means.data_ptr(), s_stds.data_ptr(),
            n, h * w, c, s, plan.cluster, plan.rows_per_block, int(plan.resident),
            int(feat.dtype == torch.float32), float(alpha), float(eps),
            float(max(h * w - ddof, 1)), stream,
        )
    if rc:
        raise RuntimeError(f"fused_adain launch failed: CUDA error {rc}")
    fused_adain_multi.launches += 1
    return out


fused_adain_multi.launches = 0


def _style_rows(s_means, s_stds, c: int, device) -> tuple:
    s_means = torch.as_tensor(s_means, dtype=torch.float32, device=device).contiguous()
    s_stds = torch.as_tensor(s_stds, dtype=torch.float32, device=device).contiguous()
    if s_means.ndim != 2 or s_means.shape[0] == 0 or s_means.shape[1] != c or (
            s_stds.shape != s_means.shape):
        raise ValueError(f"style statistics {tuple(s_means.shape)} / {tuple(s_stds.shape)} "
                         f"do not fit {c} channels")
    return s_means, s_stds


def fused_adain_given(
    feat: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor, s_means: torch.Tensor,
    s_stds: torch.Tensor, alpha: float = 1.0,
) -> torch.Tensor:
    """:func:`fused_adain_multi` with the content statistics given: (N, H, W,
    C) features, their per-(n, c) ``mean`` and ``inv_std`` (1 / sqrt(var +
    eps)), (N, C) float32, and the S rows of the (S, C) style statistics ->
    (S, N, H, W, C) in the input dtype, from one launch of an elementwise
    kernel (``ccst_adain_given`` in ``csrc/adain.cu``). Raises if an input
    requires grad under grad mode: the kernel has no backward."""
    refuse_autograd("fused_adain_given", feat, mean, inv_std, s_means, s_stds)
    if feat.device.type == "cpu":
        return fused_adain_multi_reference(feat, s_means, s_stds, alpha, mean=mean,
                                           inv_std=inv_std)
    n, h, w, c = feat.shape
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_adain_given takes bfloat16 or float32, got {feat.dtype}")
    if not feat.is_contiguous() or feat.numel() == 0:
        raise ValueError("fused_adain_given takes a contiguous, non-empty NHWC tensor")
    mean = mean.to(device=feat.device, dtype=torch.float32).contiguous()
    inv_std = inv_std.to(device=feat.device, dtype=torch.float32).contiguous()
    if mean.shape != (n, c) or inv_std.shape != (n, c):
        raise ValueError(f"content statistics {tuple(mean.shape)} / {tuple(inv_std.shape)} "
                         f"do not fit {n} images of {c} channels")
    s_means, s_stds = _style_rows(s_means, s_stds, c, feat.device)
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    s = s_means.shape[0]
    out = torch.empty((s, n, h, w, c), dtype=feat.dtype, device=feat.device)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        rc = lib.ccst_adain_given(
            feat.data_ptr(), out.data_ptr(), mean.data_ptr(), inv_std.data_ptr(),
            s_means.data_ptr(), s_stds.data_ptr(), n * h * w, h * w, c, s,
            int(feat.dtype == torch.float32), float(alpha), stream,
        )
    if rc:
        raise RuntimeError(f"fused_adain_given launch failed: CUDA error {rc}")
    fused_adain_given.launches += 1
    return out


fused_adain_given.launches = 0


def fused_adain(
    feat: torch.Tensor, s_mean: torch.Tensor, s_std: torch.Tensor,
    alpha: float = 1.0, eps: float = 1e-5, ddof: int = 1,
) -> torch.Tensor:
    """AdaIN of (N, H, W, C) features to the (C,) style statistics, blended
    with the input by ``alpha``. Returns the input dtype. The S = 1 case of
    :func:`fused_adain_multi` (the same kernel; its launches are counted
    there)."""
    refuse_autograd("fused_adain", feat, s_mean, s_std)
    if feat.device.type == "cpu":
        return fused_adain_reference(feat, s_mean, s_std, alpha, eps, ddof)
    c = feat.shape[-1]
    s_mean = torch.as_tensor(s_mean, dtype=torch.float32, device=feat.device).reshape(1, c)
    s_std = torch.as_tensor(s_std, dtype=torch.float32, device=feat.device).reshape(1, c)
    return fused_adain_multi(feat, s_mean, s_std, alpha, eps, ddof)[0]
