"""Shared layers of the classifier zoo (PyTorch, NCHW).

Counterpart of ``ccst_tpu/models/layers.py``:

- ``TorchBatchNorm`` is ``nn.BatchNorm2d(momentum=0.1, eps=1e-5)`` (and
  ``nn.BatchNorm1d`` on the 2-D activations of ``DigitModel`` / ``AlexNet``):
  flax's momentum 0.9 is torch's 0.1, and torch already stores the unbiased
  running variance that the JAX module emulates;
- :class:`InstanceNorm`, :class:`StatFreeNorm` and :class:`MixStyle` are
  written out here (``nn.InstanceNorm2d`` refuses a 1 x 1 plane in train
  mode, where JAX's gives the bias);
- the initializers draw flax's truncated normals from an explicit
  ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling divides by it)
_TRUNC_STD = 0.87962566103423978

#: one MixStyle call's draws: (gate () bool, lambda (B,) float32, permutation (B,) int64)
MixDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def variance_scaling_(w: torch.Tensor, scale: float, mode: str,
                      generator: torch.Generator) -> torch.Tensor:
    """flax ``variance_scaling(scale, mode, "truncated_normal")`` in place on a
    torch weight (OIHW conv or (out, in) linear: the fans are the same as for
    flax's HWIO / (in, out) kernels)."""
    receptive = math.prod(w.shape[2:])
    fan = (w.shape[1] if mode == "fan_in" else w.shape[0]) * receptive
    std = math.sqrt(scale / fan) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def kaiming_normal_fan_out_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """torch ``kaiming_normal_(mode='fan_out')`` as the JAX zoo draws it
    (truncated, reference nets/resnet.py:149-151)."""
    return variance_scaling_(w, 2.0, "fan_out", generator)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default ``Dense`` / ``Conv`` kernel init."""
    return variance_scaling_(w, 1.0, "fan_in", generator)


def make_norm(kind: str, channels: int) -> nn.Module:
    """norm factory: 'bn' | 'in' | 'statfree' (``classifiers.make_norm``)."""
    if kind == "bn":
        return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
    if kind == "in":
        return InstanceNorm(channels)
    if kind == "statfree":
        return StatFreeNorm()
    raise ValueError(f"unknown norm kind {kind!r}")


class InstanceNorm(nn.Module):
    """Per-(N, C) spatial normalization with an affine ``weight`` / ``bias``
    (torch ``InstanceNorm2d(affine=True)``): the sample's own statistics at
    train and eval alike, biased variance (ResNetIN, nets/resnet.py:193-232,
    and the ``--in-test`` swap, fed_run.py:218-232)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), unbiased=False, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + self.eps)
        return (out * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


class StatFreeNorm(nn.Module):
    """torch ``BatchNorm2d(affine=False, track_running_stats=False)``: batch
    statistics at train and eval alike, nothing learnable or aggregated (the
    reference DenseNet's norm, nets/densenet.py)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, None, None, training=True, eps=self.eps)


class MixStyle(nn.Module):
    """Batch-shuffled instance-statistic mixing (nets/layers.py:6-73).

    Train-only, applied with probability ``p`` a call; lambda ~ Beta(alpha,
    alpha) a sample; the statistics are detached like the reference's
    ``.detach()``. The draws of a call come from the step's generator, on the
    host (:meth:`sample`): the gate, then lambda, then the permutation, all
    three drawn whether or not the gate opens. ``torch.distributions.Beta``
    takes no generator, so lambda comes from ``numpy.random.Generator.beta``
    seeded by one draw of the generator. ``forward`` applies given draws and
    is pure (a closed gate selects the input itself), so ``torch.func.vmap``
    can apply one client's draws a slice. ``gather`` (set by
    ``parallel/fed_mesh.py::with_data_group`` for a batch split over ranks)
    joins the rows' statistics of the whole batch, whose indices the
    permutation then holds.
    """

    def __init__(self, p: float = 0.5, alpha: float = 0.1, eps: float = 1e-6):
        super().__init__()
        self.p, self.alpha, self.eps = p, alpha, eps
        self.gather = None

    def draw(self, generator: torch.Generator, b: int
             ) -> Tuple[bool, np.ndarray, torch.Tensor]:
        """(apply?, lambda (B,) float32, permutation (B,)) for one call."""
        apply = bool(torch.rand((), generator=generator) < self.p)
        seed = int(torch.randint(0, 2**62, (), generator=generator))
        lmda = np.random.default_rng(seed).beta(self.alpha, self.alpha, b).astype(np.float32)
        perm = torch.randperm(b, generator=generator)
        return apply, lmda, perm

    def sample(self, generator: torch.Generator, b: int) -> MixDraws:
        """:meth:`draw` as tensors on the host: (gate () bool, lambda (B,)
        float32, permutation (B,) int64)."""
        apply, lmda, perm = self.draw(generator, b)
        return (torch.tensor(bool(apply)), torch.from_numpy(np.asarray(lmda, np.float32)),
                torch.as_tensor(perm, dtype=torch.int64))

    def forward(self, x: torch.Tensor, draws: Optional[MixDraws] = None) -> torch.Tensor:
        if not self.training or draws is None:
            return x
        gate, lmda, perm = (t.to(x.device, non_blocking=True) for t in draws)
        lmda = lmda.view(-1, 1, 1, 1)
        xf = x.float()
        mu = xf.mean(dim=(2, 3), keepdim=True).detach()
        var = xf.var(dim=(2, 3), unbiased=False, keepdim=True).detach()
        sig = torch.sqrt(var + self.eps)
        x_normed = (xf - mu) / sig
        mu_all, sig_all = mu, sig
        if self.gather is not None:
            mu_all, sig_all = self.gather(torch.cat([mu, sig], dim=1)).chunk(2, dim=1)
        mu_mix = mu * lmda + mu_all[perm] * (1 - lmda)
        sig_mix = sig * lmda + sig_all[perm] * (1 - lmda)
        return torch.where(gate, (x_normed * sig_mix + mu_mix).to(x.dtype), x)


def max_pool_same(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """torch ``MaxPool2d(window, stride, padding)`` (-inf padding, floor)."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    return F.avg_pool2d(x, window, stride)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))
