"""FedDG amplitude-spectrum banks (the ``kfold_amp`` contract).

The reference's FedDG path loads precomputed per-image FFT amplitude ``.npy``
files found by rewriting image paths ``kfold -> kfold_amp``
(data/ImageLoader.py:211-299). This stage produces those artifacts —
amplitude of the 2D FFT of each train image at the training resolution —
and a loader that samples a bank of spectra for the on-device FedDG
augmentation (``ops/fft_aug.py``).

The package's own copy of ``ccst_tpu/pipeline/amp_bank.py`` (it imports no
JAX): the same ``.npy`` files, byte for byte, and the same banks.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from ccst_tpu_torch.data.lists import _replace_path_segment, parse_list, train_list_path
from ccst_tpu_torch.data.loader import load_image


def amp_path(image_path: str, source_marker: str = "kfold") -> str:
    base = _replace_path_segment(image_path, source_marker, f"{source_marker}_amp")
    return os.path.splitext(base)[0] + ".npy"


def compute_amp_bank(
    *,
    list_root: str,
    data_root: str,
    dataset: str,
    domain: str,
    image_size: int = 222,
    out_root: str = "",
) -> int:
    """Write one amplitude ``.npy`` (3, H, W) per train image of ``domain``."""
    names, _ = parse_list(train_list_path(list_root, dataset, domain))
    out_root = out_root or list_root
    count = 0
    for rel in names:
        src = os.path.join(data_root, rel) if data_root else rel
        img = load_image(src, image_size) * 255.0  # reference FFTs [0,255]
        chw = np.transpose(img, (2, 0, 1))
        amp = np.abs(np.fft.fft2(chw, axes=(-2, -1))).astype(np.float32)
        dst = os.path.join(out_root, amp_path(rel))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        np.save(dst, amp)
        count += 1
    return count


def load_amp_bank(
    list_root: str,
    dataset: str,
    domains: Sequence[str],
    max_per_domain: int = 64,
    data_root: str = "",
    image_size: int = 222,
    seed: int = 0,
) -> np.ndarray:
    """(K, 3, H, W) bank sampled across ``domains``. Prefers precomputed
    ``kfold_amp`` artifacts; falls back to computing spectra on the fly from
    the images themselves."""
    rng = np.random.default_rng(seed)
    bank: List[np.ndarray] = []
    for domain in domains:
        names, _ = parse_list(train_list_path(list_root, dataset, domain))
        picks = rng.permutation(len(names))[:max_per_domain]
        for i in picks:
            rel = names[i]
            root = data_root or list_root
            npy = os.path.join(root, amp_path(rel))
            if os.path.exists(npy):
                amp = np.load(npy)
            else:
                src = os.path.join(root, rel)
                img = load_image(src, image_size) * 255.0
                amp = np.abs(
                    np.fft.fft2(np.transpose(img, (2, 0, 1)), axes=(-2, -1))
                ).astype(np.float32)
            bank.append(amp[:3])
    if not bank:
        raise ValueError(f"no amplitude spectra found for {domains}")
    return np.stack(bank).astype(np.float32)
