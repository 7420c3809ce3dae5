"""Privacy analysis: invert shared style statistics back to images.

Port of ``ccst_tpu/privacy/invert.py`` (the reference's reconstruct_img/):

  - ``train_inverter``  ~ rebuttal_mapping.py:155-273: per source domain, train
    a ``StyleInverter`` mapping each image's 1024-d style vector (relu4_1
    mean ‖ std) to the image, MSE loss (``--loss mse+perceptual`` adds the
    offline LPIPS analogue), Adam, best-by-val-PSNR checkpoint;
  - ``evaluate_inverter`` ~ test.py:151-231: reconstruct held-out /
    target-domain images from their style vectors, report PSNR and the
    perceptual distance (and true LPIPS with its weights), save the
    reconstructions;
  - ``overall=True``      ~ test_overall.py:100-126: reconstruct ONE image
    from a domain's shared Overall statistic and score it against the
    domain's images.

The VGG encoder is frozen. Its grad-free passes run on K3 (``models/vgg.py``'s
kernel route): the style vector in bfloat16, as the JAX trainer casts the
encoder and the images to bf16; the perceptual distance's passes in float32
(the images' taps in training, both sides at evaluation). The
reconstruction's taps in the ``mse+perceptual`` loss carry the gradient, so
they take the autograd route (float32, the bf16-rounded weights of JAX's
``enc16``, TF32 off). The inverter itself is float32 torch with TF32 off.

Checkpoints: the port writes ``torch.save({"params": state_dict, "best"})``;
``utils/checkpoint.py::load_checkpoint`` also reads ``ccst-tpu
invert-train``'s msgpack, whose flax tree :func:`generator.from_flax` maps.

Data parallelism on ``torch.distributed`` (``parallel/multihost.py``), in two
forms, as the JAX trainer has them:

  - a multi-process launch (``coordinator`` / ``num_procs``, the reference's
    DDP loop, imagenet_reconstruct.py:141-175): each rank reads its strided
    shard of the train and val images (``train_idx[rank::ranks]``) at
    ``batch_size`` a rank, the gradients (and the loss) are averaged with one
    ``all_reduce`` a step and Adam runs alike on every rank, the val sums are
    summed over the ranks, and rank 0 alone saves and prints;
  - ``mesh``, a process group of one call: its ranks read the same batches
    and each takes its rows of the global batch, the gradients averaged over
    the group.

K3 runs every grad-free VGG pass on each rank, on that rank's rows.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ccst_tpu_torch.data.lists import parse_list, train_list_path
from ccst_tpu_torch.data.loader import ImageBatchLoader, save_image_u8
from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.ops.adain import calc_mean_std
from ccst_tpu_torch.parallel import multihost
from ccst_tpu_torch.pipeline.train_decoder import synchronize
from ccst_tpu_torch.privacy.generator import StyleInverter, from_flax
from ccst_tpu_torch.utils.optim import Adam
from ccst_tpu_torch.utils.precision import no_tf32


@dataclass
class InvertConfig:
    dataset: str = "pacs"
    source: str = "art_painting"
    list_root: str = ""
    data_root: str = ""
    image_size: int = 256
    batch_size: int = 16
    steps: int = 2000
    lr: float = 2e-4
    seed: int = 1
    val_fraction: float = 0.1
    out_dir: str = "inverter"
    vgg_weights: str = ""
    eval_limit: int = 64          # images scored at eval
    style_stats_dir: str = "style_stats"  # Overall banks (--overall eval)
    loss: str = "mse"             # "mse" | "mse+perceptual"
    perc_weight: float = 0.1      # weight of the perceptual term
    lpips_vgg: str = ""           # torchvision vgg16 .pth -> TRUE LPIPS
    lpips_lin: str = ""           # LPIPS linear-head .pth (both required)
    # multi-process launch (the reference's DDP template): one rank a process
    coordinator: str = ""
    num_procs: int = 0
    proc_id: int = -1


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB (test.py's metric), per image."""
    mse = torch.mean(torch.square(a.float() - b.float()), dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _encoder_params(cfg: InvertConfig):
    if cfg.vgg_weights:
        from ccst_tpu_torch.models.convert import load_encoder

        return load_encoder(cfg.vgg_weights)
    return vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(0))


def round_bf16(params):
    """The weights through bfloat16, back in float32 (JAX's ``enc16`` seen
    by a float32 input)."""
    return {n: {k: torch.as_tensor(np.array(v)).to(torch.bfloat16).float()
                for k, v in p.items()} for n, p in params.items()}


def style_vector(enc16: vgg.Prepared, images: torch.Tensor) -> torch.Tensor:
    """1024-d relu4_1 mean ‖ std per image (rebuttal_mapping.py:33-43), with
    population (``ddof=0``) statistics; the encoder prepared in bf16 (K3 on the
    card). float32 out. Call it under ``torch.no_grad()``."""
    feats = vgg.apply_encoder(enc16, images.to(torch.bfloat16).contiguous())
    mean, std = calc_mean_std(feats, ddof=0)
    return torch.cat([mean[:, 0, 0, :], std[:, 0, 0, :]], dim=-1)


def perceptual_from_taps(taps_a, taps_b) -> torch.Tensor:
    """Unit-normalized per-position features at the four relu taps, squared
    distance, spatial and layer mean; per image."""
    total = 0.0
    for name in taps_a:
        fa, fb = taps_a[name].float(), taps_b[name].float()
        na = fa / (torch.linalg.vector_norm(fa, dim=-1, keepdim=True) + 1e-10)
        nb = fb / (torch.linalg.vector_norm(fb, dim=-1, keepdim=True) + 1e-10)
        total = total + torch.mean(torch.sum(torch.square(na - nb), dim=-1), dim=(1, 2))
    return total / len(taps_a)


def perceptual_distance(enc: vgg.Prepared, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LPIPS-style distance of two grad-free image batches, both through the
    kernel route (K3 on the card) in the encoder's prepared dtype."""
    return perceptual_from_taps(vgg.encoder_taps(enc, a.contiguous()),
                                vgg.encoder_taps(enc, b.contiguous()))


def _split_indices(cfg: InvertConfig, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (val, train) index split: seed-deterministic, shared by the
    trainer and by ``evaluate_inverter(holdout=True)``."""
    rng = np.random.default_rng(cfg.seed)
    idx = rng.permutation(n)
    n_val = max(1, int(n * cfg.val_fraction))
    return idx[:n_val], idx[n_val:]


def _loaders(cfg: InvertConfig, shard: Tuple[int, int] = (0, 1)
             ) -> Tuple[ImageBatchLoader, ImageBatchLoader]:
    """(train, val) loaders; ``shard = (rank, ranks)`` keeps a rank's strided
    shard of both splits (the DistributedSampler analogue)."""
    names, labels = parse_list(train_list_path(cfg.list_root, cfg.dataset, cfg.source))
    if cfg.data_root:
        names = [os.path.join(cfg.data_root, n) for n in names]
    val_idx, train_idx = _split_indices(cfg, len(names))
    p, np_ = shard
    if np_ > 1:
        train_idx, val_idx = train_idx[p::np_], val_idx[p::np_]
        if len(train_idx) < cfg.batch_size:
            # with loop=True and drop_last=True a shard smaller than a batch
            # never yields one, and next() would hang every rank
            raise ValueError(f"process {p}'s train shard has {len(train_idx)} images < "
                             f"batch_size {cfg.batch_size}: use fewer processes or a smaller "
                             "batch")
    train = ImageBatchLoader(
        [names[i] for i in train_idx], [labels[i] for i in train_idx],
        batch_size=cfg.batch_size, image_size=cfg.image_size,
        shuffle=True, seed=cfg.seed, loop=True, drop_last=True,
    )
    val = ImageBatchLoader(
        [names[i] for i in val_idx], [labels[i] for i in val_idx],
        batch_size=cfg.batch_size, image_size=cfg.image_size,
    )
    return train, val


def checkpoint_path(cfg: InvertConfig) -> str:
    return os.path.join(cfg.out_dir, cfg.dataset.lower(), f"{cfg.source}_inverter.ckpt")


def load_inverter(path: str, image_size: int, device) -> StyleInverter:
    """An inverter from a checkpoint of either package."""
    from ccst_tpu_torch.utils.checkpoint import is_msgpack_checkpoint, load_checkpoint

    params = load_checkpoint(path)["params"]
    state = from_flax(params) if is_msgpack_checkpoint(path) else params
    model = StyleInverter(image_size=image_size)
    model.load_state_dict(state)
    return model.to(device).eval()


class InverterTrainer:
    """The inverter, its Adam state and the frozen encoder's forms on one
    device. ``kernel=False`` (a float64 reference) sends the images'
    perceptual taps through the autograd route too, under no_grad."""

    def __init__(self, cfg: InvertConfig, encoder_params, device,
                 dtype: torch.dtype = torch.float32, kernel: bool = True,
                 model: StyleInverter = None, group=None):
        """``group``: a process group whose ranks each hold a share of the
        batch; the gradients and the loss are averaged over it."""
        self.cfg, self.device, self.group = cfg, torch.device(device), group
        if cfg.loss not in ("mse", "mse+perceptual"):
            raise ValueError(f"unknown --loss {cfg.loss!r}")
        enc16 = round_bf16(encoder_params)
        self.perc_images = vgg.prepare_params(enc16, dtype, self.device) if kernel else None
        self.perc_recon = vgg.trainable_params(enc16, self.device, dtype, requires_grad=False)
        if model is None:
            model = StyleInverter(image_size=cfg.image_size,
                                  generator=torch.Generator().manual_seed(cfg.seed))
        self.model = model.to(self.device, dtype)
        self.opt = Adam(list(self.model.parameters()), cfg.lr)

    def loss(self, images: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        recon = self.model(z)
        loss = torch.mean(torch.square(recon - images))
        if self.cfg.loss == "mse+perceptual":
            with torch.no_grad():
                if self.perc_images is not None:
                    taps_b = vgg.encoder_taps(self.perc_images, images)
                else:
                    taps_b = vgg.encoder_taps(self.perc_recon, images, route="autograd")
            taps_a = vgg.encoder_taps(self.perc_recon, recon, route="autograd")
            loss = loss + self.cfg.perc_weight * torch.mean(perceptual_from_taps(taps_a, taps_b))
        return loss

    def step(self, images: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """One Adam step on a batch and its style vectors (both on the
        device); returns the loss, detached."""
        self.model.train()
        with no_tf32():
            loss = self.loss(images, z)
            grads = list(torch.autograd.grad(loss, self.opt.params))
        loss = loss.detach()
        if self.group is not None:
            *grads, loss = multihost.all_reduce_mean(grads + [loss], self.group)
        self.opt.step(grads)
        return loss


def train_inverter(cfg: InvertConfig, mesh=None, device="cuda") -> Dict[str, Any]:
    """Train the style inverter for one source domain; saves the best-PSNR
    params to ``{out_dir}/{dataset}/{source}_inverter.ckpt``. Returns the best
    {psnr, step}, the checkpoint path, the final loss and the training steps'
    rates (the steps after the first, validation left out). ``mesh``: a
    process group whose ranks split each batch (module docstring)."""
    import torch.distributed as dist

    from ccst_tpu_torch.utils.checkpoint import save_checkpoint

    if (cfg.coordinator or cfg.num_procs > 1) and not dist.is_initialized():
        multihost.initialize(cfg.coordinator or None,
                             cfg.num_procs if cfg.num_procs > 0 else None,
                             cfg.proc_id if cfg.proc_id >= 0 else None, device=device)
    multiproc = multihost.world_size() > 1 and mesh is None
    group = dist.group.WORLD if multiproc else mesh
    if group is not None:
        device = multihost.rank_device(device)
    rows = multihost.group_rows(cfg.batch_size, mesh) if mesh is not None else slice(None)
    enc = _encoder_params(cfg)
    trainer = InverterTrainer(cfg, enc, device, group=group)
    dev = trainer.device
    enc16 = vgg.prepare_params(enc, torch.bfloat16, dev)

    def val_psnr(images: torch.Tensor, valid: int):
        with torch.no_grad(), no_tf32():
            trainer.model.eval()
            recon = trainer.model(style_vector(enc16, images))
            p = psnr(recon, images)[:valid]
        return p.sum().double(), float(valid)

    shard = (multihost.rank(), multihost.world_size()) if multiproc else (0, 1)
    train_loader, val_loader = _loaders(cfg, shard)
    rank0 = multihost.rank() == 0
    best = {"psnr": -1.0, "step": -1}
    out_path = checkpoint_path(cfg)
    it = iter(train_loader)
    eval_every = max(50, cfg.steps // 20)
    loss = torch.tensor(float("nan"))
    train_seconds, t_start = 0.0, None
    for i in range(cfg.steps):
        batch = next(it)
        images = torch.from_numpy(batch.images[rows]).to(dev)
        if i == 1:
            synchronize(dev)
            t_start = time.perf_counter()
        with torch.no_grad():
            z = style_vector(enc16, images)
        loss = trainer.step(images, z)
        if (i + 1) % eval_every == 0 or i == cfg.steps - 1:
            if t_start is not None:
                synchronize(dev)
                train_seconds += time.perf_counter() - t_start
            sums = torch.zeros(2, dtype=torch.float64, device=dev)
            for vb in val_loader:
                s, m = val_psnr(torch.from_numpy(vb.images).to(dev), vb.valid)
                sums += torch.stack([s, torch.tensor(m, dtype=torch.float64, device=dev)])
            if multiproc:  # every rank scored its own val shard
                multihost.all_reduce_sum(sums)
            tot, n = sums.tolist()
            cur = tot / max(n, 1.0)
            if cur > best["psnr"]:
                best = {"psnr": cur, "step": i}
                if rank0:  # single writer
                    save_checkpoint(out_path, {
                        "params": {k: v.detach().cpu()
                                   for k, v in trainer.model.state_dict().items()},
                        "best": best})
            if rank0:
                print(f"step {i+1}/{cfg.steps} loss={float(loss):.5f} val_psnr={cur:.2f}dB")
            if t_start is not None:
                t_start = time.perf_counter()
    rate = (cfg.steps - 1) / train_seconds if train_seconds > 0 else float("nan")
    best["checkpoint"] = out_path
    best["final_loss"] = float(loss)
    best["steps_per_sec"] = rate
    best["img_per_sec"] = rate * cfg.batch_size * shard[1]  # every rank's images
    return best


def _domain_names(cfg: InvertConfig, domain: str, holdout: bool):
    names, labels = parse_list(train_list_path(cfg.list_root, cfg.dataset, domain))
    if holdout:
        sel = np.sort(_split_indices(cfg, len(names))[0])
        names = [names[i] for i in sel]
        labels = [labels[i] for i in sel]
    return names, labels


def _abs(cfg: InvertConfig, names):
    return [os.path.join(cfg.data_root, n) for n in names] if cfg.data_root else list(names)


def evaluate_inverter(cfg: InvertConfig, target: str = "", overall: bool = False,
                      holdout: bool = False, device="cuda") -> Dict[str, Any]:
    """Reconstruct images of ``target`` (default: the source domain) from
    their style vectors; report mean / std PSNR and perceptual distance (and
    LPIPS when both weight files are given), save the reconstructions and the
    ``psnr_perceptual`` (and ``psnr_lpips``) npy (test.py:223-230).

    ``holdout=True`` scores only the val split the trainer held out (the same
    seed-deterministic permutation); it applies to the source domain only.
    ``overall=True`` inverts the domain's Overall bank instead and scores the
    one reconstruction against up to ``eval_limit`` of its images."""
    dev = torch.device(device)
    enc = _encoder_params(cfg)
    enc16 = vgg.prepare_params(enc, torch.bfloat16, dev)
    enc32 = vgg.prepare_params(enc, torch.float32, dev)
    model = load_inverter(checkpoint_path(cfg), cfg.image_size, dev)
    out_img_dir = os.path.join(
        cfg.out_dir, cfg.dataset.lower(), f"recon_{cfg.source}"
        + (f"_to_{target}" if target else "") + ("_overall" if overall else "")
        + ("_holdout" if holdout and not target else "")
    )
    os.makedirs(out_img_dir, exist_ok=True)
    domain = target or cfg.source
    names, labels = _domain_names(cfg, domain, holdout and not target)
    loader = ImageBatchLoader(
        _abs(cfg, names[: cfg.eval_limit]), labels[: cfg.eval_limit],
        batch_size=cfg.batch_size, image_size=cfg.image_size,
    )

    if overall:
        from ccst_tpu_torch.pipeline.style_bank import load_style_stats

        stats = os.path.join(cfg.style_stats_dir, cfg.dataset.lower(), f"{domain}_mean_std.npz")
        if not os.path.exists(stats):
            stats = stats[:-4] + ".npy"
        mean, std = load_style_stats(stats)
        z = torch.from_numpy(np.concatenate([mean, std])[None]).to(dev)
        with torch.no_grad(), no_tf32():
            recon = model(z)
        img_path = os.path.join(out_img_dir, "overall.png")
        save_image_u8(recon[0].cpu().numpy(), img_path)
        recon_b = recon.expand(cfg.batch_size, *recon.shape[1:]).contiguous()
        psnrs, percs = [], []
        for batch in loader:
            images = torch.from_numpy(batch.images).to(dev)
            with torch.no_grad():
                p, d = psnr(recon_b, images), perceptual_distance(enc32, recon_b, images)
            psnrs.extend(float(v) for v in p[: batch.valid])
            percs.extend(float(v) for v in d[: batch.valid])
        report = {
            "mode": "overall",
            "holdout": bool(holdout and not target),
            "domain": domain,
            "image": img_path,
            "images_scored": len(psnrs),
            "psnr_mean": float(np.mean(psnrs)),
            "psnr_std": float(np.std(psnrs)),
            "perceptual_mean": float(np.mean(percs)),
            "perceptual_std": float(np.std(percs)),
        }
        np.save(os.path.join(out_img_dir, "psnr_perceptual.npy"), np.stack([psnrs, percs]))
        with open(os.path.join(out_img_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=2)
        return report

    rel_names = list(names[: cfg.eval_limit])  # list-relative, for path_list
    # TRUE LPIPS when the torch checkpoints are supplied (test.py:28,184);
    # otherwise the normalized-deep-feature substitute alone
    lpips = None
    if cfg.lpips_vgg and cfg.lpips_lin:
        from ccst_tpu_torch.privacy.lpips import load_lpips_weights, lpips_distance, to_device

        vggp, lins = to_device(*load_lpips_weights(cfg.lpips_vgg, cfg.lpips_lin), dev)
        lpips = lambda a, b: lpips_distance(vggp, lins, a, b)  # noqa: E731

    psnrs, percs, lpipss = [], [], []
    idx = 0
    for batch in loader:
        images = torch.from_numpy(batch.images).to(dev)
        with torch.no_grad(), no_tf32():
            recon = model(style_vector(enc16, images))
            p, d = psnr(recon, images), perceptual_distance(enc32, recon, images)
            lp = lpips(torch.clamp(recon, 0.0, 1.0), images) if lpips is not None else None
        recon_np = recon.cpu().numpy()
        for j in range(batch.valid):
            psnrs.append(float(p[j]))
            percs.append(float(d[j]))
            if lp is not None:
                lpipss.append(float(lp[j]))
            save_image_u8(recon_np[j], os.path.join(out_img_dir, f"recon_{idx}.png"))
            idx += 1
    report = {
        "domain": domain,
        "holdout": bool(holdout and not target),
        "images": len(psnrs),
        "psnr_mean": float(np.mean(psnrs)),
        "psnr_std": float(np.std(psnrs)),
        "perceptual_mean": float(np.mean(percs)),
        "perceptual_std": float(np.std(percs)),
        "recon_dir": out_img_dir,
    }
    if lpipss:
        report["lpips_mean"] = float(np.mean(lpipss))
        report["lpips_std"] = float(np.std(lpipss))
        # the reference's artifact (reconstruct_img/test.py:225-231): per-image
        # lists and averages in a dict npy
        np.save(
            os.path.join(out_img_dir, "psnr_lpips.npy"),
            {
                "psnr_list": psnrs,
                "lpips_list": lpipss,
                "path_list": rel_names[: len(psnrs)],
                "average_psnr": float(np.mean(psnrs)),
                "average_lpips": float(np.mean(lpipss)),
            },
        )
    np.save(os.path.join(out_img_dir, "psnr_perceptual.npy"), np.stack([psnrs, percs]))
    with open(os.path.join(out_img_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report
