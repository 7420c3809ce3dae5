"""Streaming per-channel statistics for style banks.

Port of ``ccst_tpu/ops/welford.py``: (count, mean, M2) in float32 with Chan's
parallel merge, stable where raw sums of x and x^2 cancel; finalization gives
the population variance with eps under the square root (reference
mean_std_computation_effcientMem.py:135-137). :func:`welford_psum` merges the
states of a ``torch.distributed`` process group, as JAX's merges a mesh axis.
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


def welford_psum(state: WelfordState, group=None) -> WelfordState:
    """Merge the states of a process group's ranks (``ccst_tpu``'s
    ``welford_psum`` over a mesh axis). The merge is associative but a
    collective only sums, so one ``all_reduce`` sums the sufficient
    statistics (n, n * mean, m2 + n * mean^2) and the state is formed back
    from them; each rank's m2 is already centred, which bounds the
    cancellation of the raw second moment."""
    from ccst_tpu_torch.parallel.multihost import all_reduce_sum

    c = state.mean.shape[0]
    stats = torch.cat([state.count.reshape(1), state.count * state.mean,
                       state.m2 + state.count * torch.square(state.mean)])
    stats = all_reduce_sum(stats, group)
    n = stats[0]
    n_safe = torch.clamp(n, min=1.0)
    mean = stats[1:c + 1] / n_safe
    m2 = stats[c + 1:] - n_safe * torch.square(mean)
    return WelfordState(count=n, mean=mean, m2=torch.clamp(m2, min=0.0))
