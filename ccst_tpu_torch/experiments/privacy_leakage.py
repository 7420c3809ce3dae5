"""The privacy finding, measured on the port: per-image style vectors leak,
the shared Overall statistic does not.

Port of the JAX project's ``experiments/privacy_leakage.py`` (the reference's
reconstruct_img/: test.py:193-230 against test_overall.py:100-126). On the
structured ``shapes4`` content of ``semantic_validation.py``, with its
invertible encoder (LSUV + autoencoder pretraining), three scores over the
held-out val split the inverter never trained on:

  per-image:      PSNR(G(z_i), image_i), z_i the image's 1024-d style vector
                  (``evaluate_inverter(holdout=True)``);
  overall:        PSNR(G(z_domain), image_i), z_domain the domain's bank;
  mean baseline:  PSNR(the domain's mean image, image_i), the best any one
                  fixed reconstruction does on average.

Expected: per-image >> overall ~= mean image. The banks are float32; the
inverters are trained by the production ``privacy/invert.py::train_inverter``
(K3 on the card: the bf16 style vector, the float32 perceptual taps at
evaluation). The run takes cuDNN's deterministic algorithms, TF32 off.

Writes ``ccst_tpu_torch/experiments/results/EXPERIMENT_PRIVACY.json`` (the
JAX script's keys, the device and the stages' wall seconds) and panels
(originals, reconstructions, the Overall reconstruction, the mean image)
under ``results/privacy_grids/{source}/``.

    python -m ccst_tpu_torch.experiments.privacy_leakage [--quick] [--device cuda|cpu]
        [--out PATH] [--grids DIR] [--workdir DIR] [--steps N]

At the ``--quick`` sizes (32 px, 300 steps, two held-out images) the gap
depends on where the weights start, on both sides (``tests/privacy_draws.py``):
the JAX script gives 2.91-8.04 dB over six draws on the CPU, the port 1.84 dB
from its default draw and more from others; ``chip_smoke.py`` phase 11 holds
the median of three of the port's draws to the 2 dB bar.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from ccst_tpu_torch.config import StylizeConfig
from ccst_tpu_torch.data.lists import parse_list, train_list_path
from ccst_tpu_torch.data.loader import ImageBatchLoader, load_image, save_image_u8
from ccst_tpu_torch.experiments.semantic_validation import (
    CLASSES,
    DOMAINS,
    RESULTS,
    _register,
    deterministic,
    device_label,
    make_experiment_encoder,
    make_shapes_dataset,
    pretrain_encoder,
    require_device,
)
from ccst_tpu_torch.models.convert import save_npz
from ccst_tpu_torch.pipeline.style_bank import compute_style_bank
from ccst_tpu_torch.privacy.invert import (
    InvertConfig,
    _split_indices,
    evaluate_inverter,
    psnr,
    train_inverter,
)

# the --quick sizes (the JAX script's)
QUICK = dict(size=32, n_per_class=6, steps=300, ae_steps=300, batch=8, sources=("rot0",))


def holdout_images(cfg: InvertConfig) -> np.ndarray:
    """The val split the inverter of ``cfg`` never saw (at most
    ``eval_limit`` images, in list order), float32 (N, H, W, 3)."""
    names, labels = parse_list(train_list_path(cfg.list_root, cfg.dataset, cfg.source))
    val_idx, _ = _split_indices(cfg, len(names))
    sel = np.sort(val_idx)
    names = [os.path.join(cfg.data_root, names[i]) for i in sel]
    labels = [labels[i] for i in sel]
    loader = ImageBatchLoader(names[: cfg.eval_limit], labels[: cfg.eval_limit],
                              batch_size=cfg.batch_size, image_size=cfg.image_size)
    return np.concatenate([b.images[: b.valid] for b in loader])


@deterministic
def run(
    workdir: str,
    out_json: str,
    grids_dir: str,
    *,
    size: int = 64,
    n_per_class: int = 24,
    steps: int = 800,
    ae_steps: int = 1200,
    batch: int = 16,
    sources=("rot0", "rot1"),
    seed: int = 1,
    device="cuda",
    init=None,
    dec=None,
    head=None,
) -> Dict:
    """The finding at these sizes; writes and returns the summary. ``init``,
    ``dec``, ``head``: the initial encoder, autoencoder decoder and tint head
    (default: ``semantic_validation.initial_weights``')."""
    dev = require_device(str(device))
    timing = []

    def clock(stage: str, t0: float, **fields) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timing.append({"stage": stage, **fields, "seconds": time.perf_counter() - t0})

    _register(size)
    root = os.path.join(workdir, "data")
    make_shapes_dataset(root, size, n_per_class, seed=seed)

    # an encoder whose relu4_1 encodes: a raw random encoder maps every
    # input to nearly one point, and every arm would reconstruct the mean image
    probes = np.stack([
        load_image(os.path.join(root, f"SHAPES4/kfold/{d}/{c}/img000.png"), size)
        for d in DOMAINS[:-1] for c in CLASSES
    ])
    t0 = time.perf_counter()
    enc = make_experiment_encoder(probes, device=dev, init=init)
    enc, _ = pretrain_encoder(root, size, ae_steps, enc, device=dev, dec=dec, head=head)
    clock("ae_pretrain", t0, steps=ae_steps)
    timing[-1]["steps_per_sec"] = ae_steps / timing[-1]["seconds"]
    enc_path = os.path.join(workdir, "encoder.npz")
    save_npz(enc_path, enc)
    stats_dir = os.path.join(workdir, "style_stats")
    bank_cfg = StylizeConfig(
        dataset="shapes4", image_size=size, batch_size=batch,
        list_root=root, data_root=root, style_stats_dir=stats_dir,
        dtype="float32",
    )
    t0 = time.perf_counter()
    for d in sources:
        compute_style_bank(bank_cfg, d, encoder_params=enc, device=dev)
    clock("banks", t0, domains=list(sources))

    os.makedirs(grids_dir, exist_ok=True)
    result: Dict[str, Dict] = {}
    for src in sources:
        cfg = InvertConfig(
            dataset="shapes4", source=src, list_root=root, data_root=root,
            image_size=size, batch_size=batch, steps=steps, seed=seed,
            out_dir=os.path.join(workdir, "inv"), vgg_weights=enc_path,
            style_stats_dir=stats_dir, eval_limit=48,
        )
        t0 = time.perf_counter()
        best = train_inverter(cfg, device=dev)
        clock("inverter_training", t0, source=src, steps=steps,
              steps_per_sec=best["steps_per_sec"])
        # both arms score the val split the trainer held out (the same
        # seed-deterministic permutation): the gap is not memorization
        t0 = time.perf_counter()
        per_image = evaluate_inverter(cfg, holdout=True, device=dev)
        overall = evaluate_inverter(cfg, overall=True, holdout=True, device=dev)
        clock("inverter_evaluation", t0, source=src)

        # the best any fixed image does on average, over the same images
        imgs = holdout_images(cfg)
        mean_img = imgs.mean(axis=0, keepdims=True)
        mean_psnrs = psnr(torch.from_numpy(np.broadcast_to(mean_img, imgs.shape).copy()),
                          torch.from_numpy(imgs)).numpy()

        gap = per_image["psnr_mean"] - overall["psnr_mean"]
        result[src] = {
            "train_best_val_psnr": best["psnr"],
            "per_image": {k: per_image[k] for k in ("psnr_mean", "psnr_std", "perceptual_mean")},
            "overall": {k: overall[k] for k in ("psnr_mean", "psnr_std", "perceptual_mean")},
            "mean_image_baseline": {
                "psnr_mean": float(mean_psnrs.mean()),
                "psnr_std": float(mean_psnrs.std()),
            },
            "leakage_gap_db": float(gap),
        }
        print(f"[{src}] per-image {per_image['psnr_mean']:.2f} dB  "
              f"overall {overall['psnr_mean']:.2f} dB  "
              f"mean-img {mean_psnrs.mean():.2f} dB  gap {gap:.2f} dB", flush=True)

        # panel: originals / per-image reconstructions / the Overall one
        panel = os.path.join(grids_dir, src)
        os.makedirs(panel, exist_ok=True)
        recon_dir = per_image["recon_dir"]
        for j in range(min(4, len(imgs))):
            save_image_u8(imgs[j], os.path.join(panel, f"orig_{j}.png"))
            shutil.copyfile(os.path.join(recon_dir, f"recon_{j}.png"),
                            os.path.join(panel, f"recon_{j}.png"))
        shutil.copyfile(overall["image"], os.path.join(panel, "overall.png"))
        save_image_u8(mean_img[0], os.path.join(panel, "mean_image.png"))

    summary = {
        "benchmark": "shapes4 structured content (class shapes x tints)",
        "image_size": size,
        "n_train_per_domain": n_per_class * 4,
        "steps": steps,
        "per_source": result,
        "finding": (
            "per-image style vectors reconstruct images; the shared "
            "domain-level Overall statistic reconstructs ~the mean image "
            "(reference rebuttal, reconstruct_img/test.py vs test_overall.py)"
        ),
        "min_leakage_gap_db": min(r["leakage_gap_db"] for r in result.values()),
        "device": device_label(dev),
        "timing": timing,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k not in ("per_source", "timing")}))
    return summary


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="CI-sized run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(RESULTS, "EXPERIMENT_PRIVACY.json"))
    ap.add_argument("--grids", default=os.path.join(RESULTS, "privacy_grids"))
    ap.add_argument("--workdir", default="")
    ap.add_argument("--steps", type=int, default=0)
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="ccst_privacy_")
    if args.quick:
        sizes = {**QUICK, "steps": args.steps or QUICK["steps"]}
        return run(workdir, args.out, args.grids, **sizes, device=args.device)
    return run(workdir, args.out, args.grids, steps=args.steps or 800, device=args.device)


if __name__ == "__main__":
    main()
