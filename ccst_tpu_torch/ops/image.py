"""On-device image preprocessing of the training stage (NHWC float tensors).

Counterpart of ``ccst_tpu/ops/image.py``: RandomResizedCrop, horizontal flip
and ImageNet normalization for training, antialiased resize and
normalization for evaluation (reference data/data_helper.py:161-181).

Each random transform is split into a draw on the host, from an explicit
``torch.Generator`` (:func:`sample_crop_boxes`, :func:`sample_flips`,
:func:`sample_train_transform`), and a pure application on the images' device
(:func:`crop_resize`, :func:`flip`, :func:`train_transform` given the draws),
so a test can feed ``ccst_tpu``'s own boxes into :func:`crop_resize`, and
``torch.func.vmap`` can apply one set of draws a client.

``crop_resize`` is ``jax.image.scale_and_translate(..., "bilinear",
antialias=True)`` for a fractional source box: per image, the (in, out)
triangle-kernel weights of each axis as JAX's ``compute_weight_mat`` builds
them (the kernel widened by 1/scale when downscaling, columns normalised,
samples outside the input zeroed), applied as two batched products.
``F.interpolate`` cannot express a box with a translation.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import math

import torch
import torch.nn.functional as F

from ccst_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD

_EPS32 = float(torch.finfo(torch.float32).eps)


@lru_cache(maxsize=16)
def _channel_constants(mean: Tuple[float, ...], std: Tuple[float, ...], dtype: torch.dtype,
                       device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Made once a device: a host-to-device copy every step would wait for the
    device."""
    return (torch.tensor(mean, dtype=dtype).to(device), torch.tensor(std, dtype=dtype).to(device))


def normalize(images: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """(x - mean) / std per channel (ImageNet constants, data_helper.py:21-31)."""
    m, s = _channel_constants(tuple(mean), tuple(std), images.dtype, images.device)
    return (images - m) / s


def sample_flips(generator: torch.Generator, n: int, p: float = 0.5) -> torch.Tensor:
    """(n,) bool on the host: which images to flip."""
    return torch.rand((n,), generator=generator) < p


def flip(images: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the images where ``flips`` is true."""
    flips = flips.to(images.device, non_blocking=True)
    return torch.where(flips[:, None, None, None], images.flip(2), images)


def sample_crop_boxes(generator: torch.Generator, n: int, h: int, w: int,
                      scale: Tuple[float, float],
                      ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)) -> torch.Tensor:
    """(n, 4) float32 boxes (y0, x0, ch, cw) on the host: RandomResizedCrop's
    area scale and log-uniform aspect, with torchvision's rejection replaced
    by clamping, as ``ccst_tpu.ops.image._sample_crop_box`` draws them."""
    u = torch.rand((n, 4), generator=generator)
    target_area = (h * w) * (u[:, 0] * (scale[1] - scale[0]) + scale[0])
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(u[:, 1] * (hi - lo) + lo)
    cw = torch.sqrt(target_area * aspect).clamp(1.0, w)
    ch = torch.sqrt(target_area / aspect).clamp(1.0, h)
    x0 = u[:, 2] * (w - cw)
    y0 = u[:, 3] * (h - ch)
    return torch.stack([y0, x0, ch, cw], dim=1)


def _resample_weights(in_size: int, out_size: int, start: torch.Tensor,
                      length: torch.Tensor) -> torch.Tensor:
    """(N, in, out) weights mapping [start, start + length) of each image onto
    ``out_size`` samples: ``compute_weight_mat`` with the triangle kernel,
    scale ``out / length`` and translation ``-start * scale``."""
    dev = start.device
    scale = out_size / length
    translation = -start * scale
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)  # (N, out)
    x = (torch.abs(sample_f[:, None, :]
                   - torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None])
         / kernel_scale[:, None, None])
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * _EPS32,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def crop_resize(images: torch.Tensor, boxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Resample box (y0, x0, ch, cw) of each (N, H, W, C) image to
    (out_size, out_size): antialiased bilinear, as ``scale_and_translate``."""
    n, h, w, c = images.shape
    boxes = boxes.to(images.device, torch.float32, non_blocking=True)
    wy = _resample_weights(h, out_size, boxes[:, 0], boxes[:, 2]).to(images.dtype)
    wx = _resample_weights(w, out_size, boxes[:, 1], boxes[:, 3]).to(images.dtype)
    rows = torch.bmm(wy.transpose(1, 2), images.reshape(n, h, w * c))  # (N, out, W*C)
    rows = rows.reshape(n, out_size, w, c).permute(0, 2, 1, 3).reshape(n, w, out_size * c)
    out = torch.bmm(wx.transpose(1, 2), rows)  # (N, out_x, out_y*C)
    return out.reshape(n, out_size, out_size, c).permute(0, 2, 1, 3).contiguous()


def resize_square(images: torch.Tensor, size: int) -> torch.Tensor:
    """Resize(S, S), antialiased bilinear (the val / test transform,
    data_helper.py:178-181): ``jax.image.resize(..., "bilinear",
    antialias=True)``."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).contiguous()


def sample_train_transform(generator: torch.Generator, n: int, h: int, w: int,
                           min_scale: float = 0.8, max_scale: float = 1.0,
                           flip_p: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(boxes (n, 4), flips (n,)) of :func:`train_transform` on the host: the
    boxes are drawn before the flips."""
    boxes = sample_crop_boxes(generator, n, h, w, (min_scale, max_scale))
    return boxes, sample_flips(generator, n, flip_p)


def train_transform(draws: Tuple[torch.Tensor, torch.Tensor], images: torch.Tensor,
                    out_size: int, min_scale: float = 0.8, max_scale: float = 1.0,
                    flip_p: float = 0.5) -> torch.Tensor:
    """RandomResizedCrop + flip + ImageNet normalize (data_helper.py:161-176)
    with the (boxes, flips) of :func:`sample_train_transform`."""
    boxes, flips = draws
    return normalize(flip(crop_resize(images, boxes, out_size), flips))


def eval_transform(images: torch.Tensor, out_size: int) -> torch.Tensor:
    x = images
    if images.shape[1] != out_size or images.shape[2] != out_size:
        x = resize_square(images, out_size)
    return normalize(x)
