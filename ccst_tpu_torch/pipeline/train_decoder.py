"""AdaIN decoder training (the trainer the reference omits).

Port of ``ccst_tpu/pipeline/train_decoder.py``. The reference ships the AdaIN
training wrapper ``Net`` (net.py:95-152) but never trains the decoder in-repo.
This stage trains it on content / style image streams with the losses of
``models/adain_net.py`` and Adam (``utils/optim.py::Adam``, ``optax.adam``
term by term), float32 with TF32 off on the card. The encoder's grad-free
passes run through K3's exact float32 route; the decoder and the encoder pass
over its output run on ``models/vgg.py``'s autograd route.

Weights in and out are the ``.npz`` format both packages read: a decoder
trained here loads in ``ccst-tpu stylize --decoder-weights``, and a
``ccst-tpu train-decoder`` output warm-starts this one (``init_decoder``).

``mesh`` (data parallelism, as the JAX trainer's ``mesh``) is a
``torch.distributed`` process group: its ranks read the same content and
style batches, each takes its rows of them, and the gradients (and the
losses) are averaged over the group with one ``all_reduce`` a step, so every
rank's decoder takes the same Adam step; rank 0 alone writes the weights.
K3 runs the frozen passes on each rank, on that rank's rows.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict

import torch

from ccst_tpu_torch.data.lists import parse_list, train_list_path
from ccst_tpu_torch.data.loader import ImageBatchLoader
from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.models.adain_net import adain_losses, decoder_leaves, frozen_encoder
from ccst_tpu_torch.parallel import multihost
from ccst_tpu_torch.utils.optim import Adam
from ccst_tpu_torch.utils.precision import no_tf32


@dataclass
class DecoderTrainConfig:
    dataset: str = "pacs"
    content_domain: str = ""        # "" = all domains pooled
    style_domain: str = ""          # "" = all domains pooled
    list_root: str = ""
    data_root: str = ""
    image_size: int = 256
    batch_size: int = 8
    steps: int = 10000
    lr: float = 1e-4
    style_weight: float = 10.0
    content_weight: float = 1.0
    seed: int = 1
    vgg_weights: str = ""
    init_decoder: str = ""          # warm-start decoder weights (.npz); ""
                                    # = random init
    out_path: str = "decoder_trained.npz"
    log_every: int = 100
    domains: str = ""               # comma-separated pool when content/style
                                    # domain is "" (e.g. sources only, so the
                                    # decoder never sees the held-out target)


def _pooled_loader(cfg: DecoderTrainConfig, domain: str) -> ImageBatchLoader:
    from ccst_tpu_torch.config import dataset_spec

    spec = dataset_spec(cfg.dataset)
    if domain:
        domains = [domain]
    elif cfg.domains:
        domains = [d.strip() for d in cfg.domains.split(",") if d.strip()]
    else:
        domains = list(spec.domains)
    names = []
    for d in domains:
        n, _ = parse_list(train_list_path(cfg.list_root, cfg.dataset, d))
        names.extend(n)
    paths = [os.path.join(cfg.data_root, n) for n in names] if cfg.data_root else names
    return ImageBatchLoader(
        paths,
        batch_size=cfg.batch_size,
        image_size=cfg.image_size,
        shuffle=True,
        seed=cfg.seed,
        loop=True,
        drop_last=True,
    )


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DecoderTrainer:
    """The decoder, its Adam state and the frozen encoder on one device."""

    def __init__(self, cfg: DecoderTrainConfig, encoder_params, decoder_params, device,
                 dtype: torch.dtype = torch.float32, kernel: bool = True, group=None):
        """``group``: a process group whose ranks each hold a share of the
        batch; the gradients and the losses are averaged over it."""
        self.cfg, self.device, self.group = cfg, torch.device(device), group
        self.encoder = frozen_encoder(encoder_params, self.device, dtype, kernel=kernel)
        self.decoder = vgg.trainable_params(decoder_params, self.device, dtype)
        self.opt = Adam(decoder_leaves(self.decoder), cfg.lr)

    def step(self, content: torch.Tensor, style: torch.Tensor):
        """One Adam step from a content and a style batch (NHWC in [0, 1] on
        the device); returns the (content, style) losses, detached."""
        with no_tf32():
            lc, ls = adain_losses(self.encoder, self.decoder, content, style)
            loss = self.cfg.content_weight * lc + self.cfg.style_weight * ls
            grads = list(torch.autograd.grad(loss, self.opt.params))
        lc, ls = lc.detach(), ls.detach()
        if self.group is not None:
            *grads, lc, ls = multihost.all_reduce_mean(grads + [lc, ls], self.group)
        self.opt.step(grads)
        return lc, ls


def train_decoder(cfg: DecoderTrainConfig, mesh=None, device="cuda") -> Dict[str, Any]:
    """Returns {final_loss_c, final_loss_s, out_path, steps_per_sec,
    img_per_sec}; writes .npz weights. The rates are those of the steps after
    the first (which builds the kernels and picks cuDNN's algorithms).
    ``mesh``: a process group whose ranks split each batch (module
    docstring)."""
    from ccst_tpu_torch.models.convert import load_decoder, load_encoder, save_npz

    if cfg.vgg_weights:
        enc = load_encoder(cfg.vgg_weights)
    else:
        enc = vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(0))
    if cfg.init_decoder:
        dec = load_decoder(cfg.init_decoder)
    else:
        dec = vgg.init_params(vgg.DECODER_ARCH, torch.Generator().manual_seed(cfg.seed))
    rows = slice(None)
    if mesh is not None:
        device = multihost.rank_device(device)
        rows = multihost.group_rows(cfg.batch_size, mesh)
    trainer = DecoderTrainer(cfg, enc, dec, device, group=mesh)
    dev = trainer.device

    content_iter = iter(_pooled_loader(cfg, cfg.content_domain))
    style_iter = iter(_pooled_loader(cfg, cfg.style_domain))
    lc = ls = torch.tensor(float("nan"))
    t0 = time.perf_counter()
    t_warm = None
    for i in range(cfg.steps):
        cb = next(content_iter)
        sb = next(style_iter)
        lc, ls = trainer.step(torch.from_numpy(cb.images[rows]).to(dev),
                              torch.from_numpy(sb.images[rows]).to(dev))
        if i == 0:
            synchronize(dev)
            t_warm = time.perf_counter()
        if (i + 1) % cfg.log_every == 0 and multihost.rank() == 0:
            print(
                f"step {i+1}/{cfg.steps} loss_c={float(lc):.4f} "
                f"loss_s={float(ls):.4f} "
                f"({(i+1)*cfg.batch_size/(time.perf_counter()-t0):.1f} img/s)",
                flush=True,
            )
    synchronize(dev)
    steady = time.perf_counter() - t_warm if t_warm is not None else 0.0
    if multihost.rank() == 0:  # single writer
        os.makedirs(os.path.dirname(cfg.out_path) or ".", exist_ok=True)
        save_npz(cfg.out_path, vgg.params_from_trainable(trainer.decoder))
    rate = (cfg.steps - 1) / steady if cfg.steps > 1 and steady > 0 else float("nan")
    return {
        "final_loss_c": float(lc),
        "final_loss_s": float(ls),
        "out_path": cfg.out_path,
        "steps_per_sec": rate,
        "img_per_sec": rate * cfg.batch_size,
    }
