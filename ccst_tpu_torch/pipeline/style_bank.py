"""Per-domain style-bank computation (CCST pipeline stage 1).

Port of ``ccst_tpu/pipeline/style_bank.py``: stream a domain's train images
through the VGG encoder to relu4_1 and fold per-channel moments into a float32
Welford state (reference style_transfer/AdaIN/mean_std_computation_effcientMem.py
:89-156). Per batch, the moments come from the channel-moments kernel
(``kernels/moments.py``) and are Chan-merged on the device; feature maps never
leave it. The bank is written in the reference ``.npy`` layout
``[mean(1,C,1,1), std(1,C,1,1)]`` and the native ``.npz``, byte for byte as
``ccst_tpu`` writes them, so banks from either package feed the other.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Tuple

import numpy as np
import torch

from ccst_tpu_torch.config import StylizeConfig
from ccst_tpu_torch.data.lists import parse_list, train_list_path
from ccst_tpu_torch.data.loader import ImageBatchLoader
from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.ops.welford import (
    WelfordState,
    welford_finalize,
    welford_init,
    welford_update,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """The compute dtype named by ``StylizeConfig.dtype``."""
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def make_bank_step(
    encoder_params, dtype: torch.dtype = torch.bfloat16, device="cpu"
) -> Callable[[WelfordState, torch.Tensor, int], WelfordState]:
    """Returns ``step(state, images, valid) -> state``.

    ``images`` is an (N, H, W, 3) float batch in [0, 1]; only its first
    ``valid`` rows are real (the loader pads the final batch), and only they
    reach the moments: count = valid * H * W."""
    params = vgg.prepare_params(encoder_params, dtype, device)

    def step(state: WelfordState, images: torch.Tensor, valid: int) -> WelfordState:
        images = torch.as_tensor(images).to(device=device, dtype=dtype)
        return welford_update(state, vgg.apply_encoder(params, images)[:valid])

    return step


def compute_style_bank(
    cfg: StylizeConfig, domain: str, encoder_params=None, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Compute and persist the (mean, std) style bank for ``domain``.

    Returns float32 (C,) arrays and writes, under
    ``{style_stats_dir}/{dataset}/``, ``{domain}_mean_std.npy`` (reference
    layout), ``{domain}_mean_std.npz`` and ``{domain}_style_comp_time.json``."""
    if encoder_params is None:
        from ccst_tpu_torch.models.convert import load_encoder

        encoder_params = load_encoder(cfg.vgg_weights)
    names, labels = parse_list(train_list_path(cfg.list_root, cfg.dataset, domain))
    if cfg.data_root:
        names = [os.path.join(cfg.data_root, n) for n in names]
    loader = ImageBatchLoader(
        names, labels, batch_size=cfg.batch_size, image_size=cfg.image_size,
        shuffle=False,
    )
    step = make_bank_step(encoder_params, torch_dtype(cfg.dtype), device)
    state = welford_init(512, device)
    t0 = time.perf_counter()
    n_images = 0
    for batch in loader:
        state = step(state, torch.from_numpy(batch.images), batch.valid)
        n_images += batch.valid
    mean, std = welford_finalize(state)
    mean_np = mean.cpu().numpy()  # waits for the device
    std_np = std.cpu().numpy()
    elapsed = time.perf_counter() - t0

    out_dir = os.path.join(cfg.style_stats_dir, cfg.dataset.lower())
    save_style_stats(out_dir, domain, mean_np, std_np)
    with open(os.path.join(out_dir, f"{domain}_style_comp_time.json"), "w") as f:
        json.dump(
            {
                "domain": domain,
                "seconds": elapsed,
                "images": n_images,
                "images_per_sec": n_images / max(elapsed, 1e-9),
                "image_size": cfg.image_size,
                "batch_size": cfg.batch_size,
            },
            f,
            indent=2,
        )
    return mean_np, std_np


def save_style_stats(out_dir: str, domain: str, mean: np.ndarray, std: np.ndarray) -> None:
    os.makedirs(out_dir, exist_ok=True)
    mean = np.asarray(mean, np.float32).reshape(-1)
    std = np.asarray(std, np.float32).reshape(-1)
    c = mean.shape[0]
    # reference-compatible: np.save([mean(1,C,1,1), std(1,C,1,1)])
    ref_layout = np.stack([mean.reshape(1, c, 1, 1), std.reshape(1, c, 1, 1)], axis=0)
    np.save(os.path.join(out_dir, f"{domain}_mean_std.npy"), ref_layout)
    np.savez(os.path.join(out_dir, f"{domain}_mean_std.npz"), mean=mean, std=std)


def load_style_stats(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Style stats from the native ``.npz`` or the reference ``.npy``
    ([mean, std] each (1,C,1,1)), as float32 (C,) vectors."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return (
                data["mean"].astype(np.float32).reshape(-1),
                data["std"].astype(np.float32).reshape(-1),
            )
    arr = np.load(path)
    return (
        np.asarray(arr[0], np.float32).reshape(-1),
        np.asarray(arr[1], np.float32).reshape(-1),
    )
