"""Streaming per-channel statistics for style banks.

Port of ``ccst_tpu/ops/welford.py``: (count, mean, M2) in float32 with Chan's
parallel merge, stable where raw sums of x and x^2 cancel; finalization gives
the population variance with eps under the square root (reference
mean_std_computation_effcientMem.py:135-137).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ccst_tpu_torch.kernels.moments import channel_moments


class WelfordState(NamedTuple):
    """Per-channel streaming moments, float32."""

    count: torch.Tensor  # () samples folded in (every channel sees the same)
    mean: torch.Tensor   # (C,)
    m2: torch.Tensor     # (C,) sum of squared deviations from the mean


def welford_init(channels: int, device="cpu") -> WelfordState:
    zeros = torch.zeros((channels,), dtype=torch.float32, device=device)
    return WelfordState(
        count=torch.zeros((), dtype=torch.float32, device=device),
        mean=zeros,
        m2=zeros.clone(),
    )


def welford_merge(a: WelfordState, b: WelfordState) -> WelfordState:
    """Chan's parallel merge; associative and safe when either side is empty."""
    n = a.count + b.count
    delta = b.mean - a.mean
    frac_b = torch.where(n > 0, b.count / torch.clamp(n, min=1.0), torch.zeros_like(n))
    mean = a.mean + delta * frac_b
    m2 = a.m2 + b.m2 + torch.square(delta) * a.count * frac_b
    return WelfordState(count=n, mean=mean, m2=m2)


def welford_update(state: WelfordState, feat: torch.Tensor) -> WelfordState:
    """Fold an NHWC feature batch, as one population, into the running state
    (its moments come from the channel-moments kernel on a CUDA tensor)."""
    mean, m2, count = channel_moments(feat)
    return welford_merge(state, WelfordState(count=count, mean=mean, m2=m2))


def welford_finalize(
    state: WelfordState, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) with population variance + eps."""
    var = state.m2 / torch.clamp(state.count, min=1.0)
    return state.mean, torch.sqrt(var + eps)
