"""Seeded synthetic images, made in a few large calls on the given device.

The recipe of ``ccst_tpu_torch/benchmarks/stylize_profile.py::write_tree``,
drawn with torch instead of numpy: a plane of uniform colour blocks (a 32nd
of the side, at least one pixel) plus Gaussian noise of 0.05, clipped to
[0, 1] and quantized to uint8 as ``save_image`` does (x 255, + 0.5, floor).
"""
from __future__ import annotations

import torch

CHUNK = 32  # images drawn a call: bounds the float32 scratch at 512 px to 100 MB


def blocky_noise(generator: torch.Generator, n: int, size: int) -> torch.Tensor:
    """(n, size, size, 3) uint8 on the generator's device."""
    dev = generator.device
    block = max(size // 32, 1)
    cells = -(-size // block)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=dev)
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        base = torch.rand((m, cells, cells, 3), generator=generator, device=dev)
        img = base.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :size, :size]
        noise = torch.randn(img.shape, generator=generator, device=dev)
        img = torch.clamp(img + 0.05 * noise, 0.0, 1.0) * 255.0 + 0.5
        out[i:i + m] = img.to(torch.uint8)
    return out
