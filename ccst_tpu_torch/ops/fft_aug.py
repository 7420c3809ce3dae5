"""ELCFS / FedDG frequency-space augmentation on ``torch.fft``.

Counterpart of ``ccst_tpu/ops/fft_aug.py`` (reference data/ImageLoader.py:
161-208): blend the low-frequency amplitude band of a source image with a
target domain's amplitude spectrum, keep the source phase, invert.

Reference semantics kept: box half-width b = floor(min(h, w) * L), and
fed_run's L = 0 blends only the DC bin; the blend ratio is uniform over
{0.1, ..., 0.9}; images are in [0, 255] during the FFT and clipped back.

The functions take any leading batch dimensions; a blend ``ratio`` has the
batch shape (or is a number). The picks and ratios of a batch are drawn on
the host (:func:`sample_feddg_draws`), separately, and applied on the images'
device (:func:`feddg_augment`, pure: ``torch.func.vmap`` applies one client's
draws a slice).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

Ratio = Union[float, torch.Tensor]


def amplitude_spectrum(images_hwc: torch.Tensor) -> torch.Tensor:
    """Per-channel FFT amplitude |F(x)| of (..., H, W, C) images, in (..., C,
    H, W) order like the reference's saved banks."""
    return torch.abs(torch.fft.fft2(images_hwc.movedim(-1, -3), dim=(-2, -1)))


def _ratio(ratio: Ratio, like: torch.Tensor) -> torch.Tensor:
    r = ratio if isinstance(ratio, torch.Tensor) else torch.tensor(ratio, dtype=like.dtype)
    r = r.to(like.device, like.dtype, non_blocking=True)
    return r.reshape(r.shape + (1, 1, 1))


def low_freq_mutate(amp_src: torch.Tensor, amp_trg: torch.Tensor, ratio: Ratio,
                    L: float = 0.0) -> torch.Tensor:
    """Blend the centred low-frequency box of two (..., C, H, W) amplitude
    spectra: src * ratio + trg * (1 - ratio) (ImageLoader.py:161-183)."""
    a_src = torch.fft.fftshift(amp_src, dim=(-2, -1))
    a_trg = torch.fft.fftshift(amp_trg, dim=(-2, -1))
    h, w = a_src.shape[-2:]
    c_h, c_w = h // 2, w // 2
    # clamped like ccst_tpu: the reference's box wraps for L >= 0.5
    b = max(min(int(min(h, w) * L), min(c_h, c_w) - 1), 0) if L > 0 else 0
    h1, h2, w1, w2 = c_h - b, c_h + b + 1, c_w - b, c_w + b + 1
    r = _ratio(ratio, a_src)
    a_src = a_src.clone()
    a_src[..., h1:h2, w1:w2] = a_src[..., h1:h2, w1:w2] * r + a_trg[..., h1:h2, w1:w2] * (1 - r)
    return torch.fft.ifftshift(a_src, dim=(-2, -1))


def source_to_target_freq(src_img_hwc: torch.Tensor, amp_trg: torch.Tensor, ratio: Ratio,
                          L: float = 0.0) -> torch.Tensor:
    """Swap the low-frequency amplitude of ``src`` for ``amp_trg``, keep the
    phase (ImageLoader.py:185-208). Images in [0, 255], output clipped there."""
    fft_src = torch.fft.fft2(src_img_hwc.movedim(-1, -3), dim=(-2, -1))
    amp_src, pha_src = torch.abs(fft_src), torch.angle(fft_src)
    amp_mut = low_freq_mutate(amp_src, amp_trg, ratio, L=L)
    out = torch.fft.ifft2(amp_mut * torch.exp(1j * pha_src), dim=(-2, -1)).real
    return torch.clamp(out.movedim(-3, -1), 0.0, 255.0)


def sample_feddg_draws(generator: torch.Generator, n: int, bank_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(picks (n,) int64, ratios (n,) float32) on the host: a bank entry and
    a blend ratio in {0.1, ..., 0.9} for each image, drawn separately."""
    picks = torch.randint(0, bank_size, (n,), generator=generator)
    ratios = torch.randint(1, 10, (n,), generator=generator).float() / 10.0
    return picks, ratios


def feddg_augment(images: torch.Tensor, amp_bank: torch.Tensor, picks: torch.Tensor,
                  ratios: torch.Tensor, L: float = 0.0) -> torch.Tensor:
    """FedDG view of [0, 1] (N, H, W, C) images against ``amp_bank`` (K, C, H,
    W) on the same device, with the given picks and ratios."""
    trg = amp_bank[picks.to(amp_bank.device, non_blocking=True)]
    return source_to_target_freq(images * 255.0, trg, ratios, L=L) / 255.0
