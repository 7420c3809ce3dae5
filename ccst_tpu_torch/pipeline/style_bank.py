"""Per-domain style-bank computation (CCST pipeline stage 1).

Port of ``ccst_tpu/pipeline/style_bank.py``: stream a domain's train images
through the VGG encoder to relu4_1 and fold per-channel moments into a float32
Welford state (reference style_transfer/AdaIN/mean_std_computation_effcientMem.py
:89-156). Per batch, the moments come from the channel-moments kernel
(``kernels/moments.py``) and are Chan-merged on the device; feature maps never
leave it. The bank is written in the reference ``.npy`` layout
``[mean(1,C,1,1), std(1,C,1,1)]`` and the native ``.npz``, byte for byte as
``ccst_tpu`` writes them, so banks from either package feed the other.

WCT's second-order bank (``--model wct``; ``ccst_tpu`` has none): for each of
the five levels ``vgg.WCT_LEVELS``, the mean and covariance of every position
of every image of the domain, summed in float64 on the device over the
batches, and the colouring matrix ``S^1/2`` worked out once from the
covariance (``ops/wct.py::colour_of``). Written as ``{domain}_wct.npz``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, NamedTuple, Tuple

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


# ---------------------------------------------------------------------------
# WCT's second-order bank
# ---------------------------------------------------------------------------


class WCTBank(NamedTuple):
    """One domain's WCT bank, by level: ``mean`` (C,) float32, ``cov`` (C, C)
    and ``colour`` ``S^1/2`` (C, C) float64, ``count`` positions."""

    mean: Dict[str, torch.Tensor]
    cov: Dict[str, torch.Tensor]
    colour: Dict[str, torch.Tensor]
    count: Dict[str, int]


WCTSums = Dict[str, Tuple[int, torch.Tensor, torch.Tensor]]  # level -> (n, sum x, sum x x^T)


def wct_bank_init() -> WCTSums:
    return {}


def wct_bank_update(sums: WCTSums, taps: Dict[str, torch.Tensor]) -> WCTSums:
    """Fold one batch's features (level -> (N, H, W, C)) into the float64
    sums, an image at a time (bounding the float64 copy of a relu1_1 map)."""
    out = dict(sums)
    for level, feat in taps.items():
        c = feat.shape[-1]
        n, s1, s2 = out.get(level, (0, None, None))
        if s1 is None:
            s1 = torch.zeros(c, dtype=torch.float64, device=feat.device)
            s2 = torch.zeros(c, c, dtype=torch.float64, device=feat.device)
        for img in feat:
            x = img.reshape(-1, c).double()
            s1 = s1 + x.sum(dim=0)
            s2 = torch.addmm(s2, x.T, x)
            n += x.shape[0]
        out[level] = (n, s1, s2)
    return out


def wct_bank_finalize(sums: WCTSums) -> WCTBank:
    """Mean, covariance (divisor n - 1, as PytorchWCT's) and ``S^1/2``."""
    from ccst_tpu_torch.ops.wct import colour_of

    bank = WCTBank({}, {}, {}, {})
    for level, (n, s1, s2) in sums.items():
        mean = s1 / n
        cov = (s2 - n * torch.outer(mean, mean)) / (n - 1)
        bank.mean[level] = mean.float()
        bank.cov[level] = cov
        bank.colour[level] = colour_of(cov)
        bank.count[level] = n
    return bank


def make_wct_bank_step(encoder_params, dtype: torch.dtype = torch.bfloat16, device="cpu"
                       ) -> Callable[[WCTSums, torch.Tensor, int], WCTSums]:
    """Returns ``step(sums, images, valid) -> sums``: the first ``valid`` of an
    (N, H, W, 3) batch in [0, 1] encoded once to relu5_1, every level
    tapped on the way."""
    params = vgg.prepare_params(encoder_params, dtype, device)

    def step(sums: WCTSums, images: torch.Tensor, valid: int) -> WCTSums:
        images = torch.as_tensor(images)[:valid].to(device=device, dtype=dtype)
        _, taps = vgg.encode_to(params, images, vgg.WCT_LEVELS[0], taps=vgg.WCT_LEVELS)
        return wct_bank_update(sums, taps)

    return step


def compute_wct_bank(cfg: StylizeConfig, domain: str, encoder_params, device="cuda") -> WCTBank:
    """Compute and persist ``domain``'s WCT bank under
    ``{style_stats_dir}/{dataset}/{domain}_wct.npz``."""
    names, labels = parse_list(train_list_path(cfg.list_root, cfg.dataset, domain))
    if cfg.data_root:
        names = [os.path.join(cfg.data_root, n) for n in names]
    loader = ImageBatchLoader(names, labels, batch_size=cfg.batch_size,
                              image_size=cfg.image_size, shuffle=False)
    step = make_wct_bank_step(encoder_params, torch_dtype(cfg.dtype), device)
    sums = wct_bank_init()
    for batch in loader:
        sums = step(sums, torch.from_numpy(batch.images), batch.valid)
    bank = wct_bank_finalize(sums)
    save_wct_bank(wct_bank_path(cfg, domain), bank)
    return bank


def wct_bank_path(cfg: StylizeConfig, domain: str) -> str:
    return os.path.join(cfg.style_stats_dir, cfg.dataset.lower(), f"{domain}_wct.npz")


def save_wct_bank(path: str, bank: WCTBank) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {}
    for level in bank.mean:
        flat[f"mean.{level}"] = bank.mean[level].cpu().numpy()
        flat[f"cov.{level}"] = bank.cov[level].cpu().numpy()
        flat[f"colour.{level}"] = bank.colour[level].cpu().numpy()
        flat[f"count.{level}"] = np.int64(bank.count[level])
    np.savez(path, **flat)


def load_wct_bank(path: str) -> WCTBank:
    bank = WCTBank({}, {}, {}, {})
    with np.load(path) as data:
        for key in data.files:
            kind, level = key.split(".", 1)
            value = data[key]
            if kind == "count":
                bank.count[level] = int(value)
            else:
                getattr(bank, kind)[level] = torch.from_numpy(value)
    return bank
