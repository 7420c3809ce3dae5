"""Adversarial training surface for the privacy subsystem.

Port of ``ccst_tpu/privacy/gan.py`` (the reference vendors lucidrains'
lightweight-GAN: Generator, Discriminator, DiffAugment, hinge losses and
AdaBelief in its Trainer):

  - a lightweight discriminator: strided downsampling blocks to two logit
    grids (8x8 and from the 32x32 features), with an auxiliary
    ``SimpleDecoder`` that reconstructs a 32 px version of the real batch;
  - DiffAugment (color / translation / cutout) on real and fake batches inside
    the losses. Each random transform is a draw on the host from one
    ``torch.Generator`` (:func:`sample_augment`) and its application on the
    device (:func:`apply_augment`), so a test can feed ``ccst_tpu``'s draws in;
  - hinge losses, ``optax.adabelief(b1=0.5, b2=0.9)`` (``utils/optim.py``),
    the R1-style penalty every ``gp_every`` steps (a gradient through the
    discriminator's input gradient), an EMA generator.

Modules carry flax's child names as ``privacy/generator.py``'s do
(:func:`generator.from_flax` maps ``ccst_tpu``'s trees). float32, TF32 off on
the card. The closing VGG-Frechet distance encodes through K3's float32 route.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ccst_tpu_torch.ops.image import resize_square
from ccst_tpu_torch.privacy.generator import (
    Conv,
    LinearAttention,
    StyleInverter,
    _upsample2x,
)
from ccst_tpu_torch.utils.optim import AdaBelief
from ccst_tpu_torch.utils.precision import no_tf32

# ---------------------------------------------------------------------------
# DiffAugment (diff_augment.py parity: color, translation, cutout)
# ---------------------------------------------------------------------------

POLICIES = ("color", "translation", "cutout")
TRANSLATION_RATIO, CUTOUT_RATIO = 0.125, 0.5


def _uniform(g: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return torch.rand((n,), generator=g) * (hi - lo) + lo


def _policy_names(policy: str) -> List[str]:
    names = [p.strip() for p in policy.split(",") if p.strip()]
    unknown = sorted(set(names) - set(POLICIES))
    if unknown:
        raise ValueError(f"unknown augment policies {unknown}")
    return names


def sample_augment(g: torch.Generator, n: int, h: int, w: int,
                   policy: str = "color,translation,cutout") -> List[Tuple[str, Dict]]:
    """The host draws of each policy in order, for ``n`` images of h x w:
    color (brightness U(-0.5, 0.5), saturation U(0, 2), contrast U(0.5, 1.5)),
    translation (integer shifts in (-s, s), s = int(side / 8) + 1), cutout
    (the half-side box's corner)."""
    out = []
    for name in _policy_names(policy):
        if name == "color":
            d = {"brightness": _uniform(g, n, -0.5, 0.5), "saturation": _uniform(g, n, 0.0, 2.0),
                 "contrast": _uniform(g, n, 0.5, 1.5)}
        elif name == "translation":
            sh, sw = int(h * TRANSLATION_RATIO) + 1, int(w * TRANSLATION_RATIO) + 1
            d = {"tx": torch.randint(-sh + 1, sh, (n,), generator=g),
                 "ty": torch.randint(-sw + 1, sw, (n,), generator=g)}
        else:
            ch, cw = int(h * CUTOUT_RATIO), int(w * CUTOUT_RATIO)
            d = {"ox": torch.randint(0, h - ch + 1, (n,), generator=g),
                 "oy": torch.randint(0, w - cw + 1, (n,), generator=g)}
        out.append((name, d))
    return out


def _aug_color(x: torch.Tensor, d) -> torch.Tensor:
    view = lambda t: t.to(x.device, x.dtype).view(-1, 1, 1, 1)  # noqa: E731
    x = x + view(d["brightness"])
    mean_c = x.mean(dim=-1, keepdim=True)
    x = (x - mean_c) * view(d["saturation"]) + mean_c
    mean_all = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean_all) * view(d["contrast"]) + mean_all


def _aug_translation(x: torch.Tensor, d) -> torch.Tensor:
    """out[i, j] = x[i + tx, j + ty], zero outside the image."""
    n, h, w, _ = x.shape
    sh, sw = int(h * TRANSLATION_RATIO) + 1, int(w * TRANSLATION_RATIO) + 1
    padded = F.pad(x, (0, 0, sw, sw, sh, sh))
    rows = torch.arange(h, device=x.device)[None] + (sh + d["tx"].to(x.device))[:, None]
    cols = torch.arange(w, device=x.device)[None] + (sw + d["ty"].to(x.device))[:, None]
    idx = torch.arange(n, device=x.device)[:, None, None]
    return padded[idx, rows[:, :, None], cols[:, None, :]]


def _aug_cutout(x: torch.Tensor, d) -> torch.Tensor:
    n, h, w, _ = x.shape
    ch, cw = int(h * CUTOUT_RATIO), int(w * CUTOUT_RATIO)
    ox = d["ox"].to(x.device).view(-1, 1, 1)
    oy = d["oy"].to(x.device).view(-1, 1, 1)
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    mask = (rows >= ox) & (rows < ox + ch) & (cols >= oy) & (cols < oy + cw)
    return x * (1.0 - mask[..., None].to(x.dtype))


_APPLY = {"color": _aug_color, "translation": _aug_translation, "cutout": _aug_cutout}


def apply_augment(x: torch.Tensor, draws: Sequence[Tuple[str, Dict]]) -> torch.Tensor:
    """Differentiable augmentation of NHWC [0, 1] images with given draws."""
    for name, d in draws:
        x = _APPLY[name](x, d)
    return x


def diff_augment(g: torch.Generator, x: torch.Tensor,
                 policy: str = "color,translation,cutout") -> torch.Tensor:
    """Draw from ``g`` and augment (diff_augment.py:5-16)."""
    n, h, w, _ = x.shape
    return apply_augment(x, sample_augment(g, n, h, w, policy))


# ---------------------------------------------------------------------------
# Discriminator (+ self-supervised decoder)
# ---------------------------------------------------------------------------


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """flax's ``leaky_relu``, ``where(x >= 0, x, slope x)``: its gradient at
    exactly 0 is 1 (torch's ``F.leaky_relu`` gives the slope there). Zero
    biases at init and the augmentations' zeroed regions put whole planes at 0."""
    return torch.where(x >= 0, x, slope * x)


class _DownBlock(nn.Module):
    def __init__(self, cin: int, features: int, generator=None):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 4, stride=2, padding=1, generator=generator)
        self.Conv_1 = Conv(features, features, 3, padding=1, generator=generator)
        self.Conv_2 = Conv(cin, features, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.Conv_0(x), 0.1)
        y = leaky_relu(self.Conv_1(y), 0.1)
        # averaged-pool residual branch, like the upstream's SumBranches
        r = self.Conv_2(F.avg_pool2d(x, 2))
        return (y + r) * (0.5 ** 0.5)


class SimpleDecoder(nn.Module):
    """A small RGB image from a D feature map (upsample + conv chain)."""

    def __init__(self, cin: int, in_size: int, out_size: int = 32, generator=None):
        super().__init__()
        self.n_ups, c, size = 0, cin, in_size
        while size < out_size:
            cout = max(c // 2, 16)
            setattr(self, f"Conv_{self.n_ups}", Conv(c, cout, 3, padding=1, generator=generator))
            c, size, self.n_ups = cout, size * 2, self.n_ups + 1
        setattr(self, f"Conv_{self.n_ups}", Conv(c, 3, 3, padding=1, generator=generator))

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        x = f
        for i in range(self.n_ups):
            x = leaky_relu(getattr(self, f"Conv_{i}")(_upsample2x(x)), 0.1)
        return torch.sigmoid(getattr(self, f"Conv_{self.n_ups}")(x))


class Discriminator(nn.Module):
    """Downsampling stack -> patch logits at two scales + aux decoder. NHWC
    in; logits (B, 8, 8, 1) and (B, s, s, 1), the reconstruction (B, 32, 32,
    3), all NHWC."""

    def __init__(self, image_size: int = 256, fmap_max: int = 256,
                 attn_res: Sequence[int] = (), generator: Optional[torch.Generator] = None):
        super().__init__()
        res, c, cin, i = image_size, 16, 3, 0
        feats = []  # (res, channels) after each block
        self.attn_res = tuple(attn_res)
        while res > 8:
            cout = min(c, fmap_max)
            setattr(self, f"_DownBlock_{i}", _DownBlock(cin, cout, generator))
            res //= 2
            if res in self.attn_res:
                setattr(self, f"attn_{res}", LinearAttention(cout, generator=generator))
            feats.append((res, cout))
            cin, c, i = cout, c * 2, i + 1
        self.n_blocks = i
        self._f32 = next((k for k, (r, _) in enumerate(feats) if r == 32), len(feats) - 1)
        self.Conv_0 = Conv(min(c, fmap_max), 1, 1, generator=generator)
        self.Conv_1 = Conv(cin, min(c, fmap_max), 1, generator=generator)
        self.Conv_2 = Conv(feats[self._f32][1], 1, 4, stride=4, generator=generator)
        self.SimpleDecoder_0 = SimpleDecoder(cin, res, 32, generator)

    def forward(self, x: torch.Tensor, decode: bool = False):
        x = x.permute(0, 3, 1, 2)
        feats = []
        for i in range(self.n_blocks):
            x = getattr(self, f"_DownBlock_{i}")(x)
            if x.shape[2] in self.attn_res:
                x = x + getattr(self, f"attn_{x.shape[2]}")(x)
            feats.append(x)
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        logits_main = self.Conv_0(leaky_relu(self.Conv_1(x), 0.1))
        logits_32 = self.Conv_2(feats[self._f32])
        if not decode:
            return nhwc(logits_main), nhwc(logits_32)
        return (nhwc(logits_main), nhwc(logits_32)), nhwc(self.SimpleDecoder_0(x))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclass
class GanConfig:
    image_size: int = 256
    latent_dim: int = 256
    batch_size: int = 8
    lr: float = 2e-4            # upstream Trainer default
    ttur_mult: float = 1.0
    steps: int = 100
    aug_policy: str = "color,translation,cutout"
    recon_weight: float = 1.0
    ema_decay: float = 0.995
    seed: int = 0
    fmap_max: int = 256
    gp_weight: float = 0.0      # >0 enables the R1-style gradient penalty
    gp_every: int = 4
    attn_res: tuple = ()        # LinearAttention resolutions in G and D


class GanTrainer:
    """Hinge-loss GAN with DiffAugment, aux reconstruction, EMA generator, on
    one device. Draws (latents, augmentations) come from a host generator
    seeded from ``cfg.seed``; :meth:`train_step` also takes them given."""

    def __init__(self, cfg: GanConfig, device="cuda", dtype: torch.dtype = torch.float32):
        self.cfg, self.device = cfg, torch.device(device)
        init = torch.Generator().manual_seed(cfg.seed)
        self.gen = StyleInverter(image_size=cfg.image_size, latent_dim=cfg.latent_dim,
                                 fmap_max=cfg.fmap_max, attn_res=tuple(cfg.attn_res),
                                 generator=init).to(self.device, dtype)
        self.disc = Discriminator(image_size=cfg.image_size, fmap_max=cfg.fmap_max,
                                  attn_res=tuple(cfg.attn_res),
                                  generator=init).to(self.device, dtype)
        self.g_ema = copy.deepcopy(self.gen).requires_grad_(False)
        self.g_opt = AdaBelief(list(self.gen.parameters()), cfg.lr, b1=0.5, b2=0.9)
        self.d_opt = AdaBelief(list(self.disc.parameters()), cfg.lr * cfg.ttur_mult,
                               b1=0.5, b2=0.9)
        self.draws = torch.Generator().manual_seed(cfg.seed + 1)

    def load_flax(self, g_params, d_params) -> None:
        """Start from ``ccst_tpu``'s parameter trees (the EMA copy too)."""
        from ccst_tpu_torch.privacy.generator import from_flax

        self.gen.load_state_dict(from_flax(g_params))
        self.disc.load_state_dict(from_flax(d_params))
        self.g_ema.load_state_dict(self.gen.state_dict())

    def sample_draws(self, n: int) -> Dict:
        c = self.cfg
        s = c.image_size
        return {"z_d": torch.randn((n, c.latent_dim), generator=self.draws),
                "aug_real": sample_augment(self.draws, n, s, s, c.aug_policy),
                "aug_fake": sample_augment(self.draws, n, s, s, c.aug_policy),
                "z_g": torch.randn((n, c.latent_dim), generator=self.draws),
                "aug_g": sample_augment(self.draws, n, s, s, c.aug_policy)}

    def _gp(self, real_aug: torch.Tensor) -> torch.Tensor:
        """R1-style penalty (lightweight_gan.py:1220-1235) at the augmented
        real batch: ((||d(sum logits)/dx||_2 - 1)^2).mean(), kept in the graph."""
        x = real_aug.detach().requires_grad_()
        lm, l32 = self.disc(x)
        (g,) = torch.autograd.grad(lm.sum() + l32.sum(), x, create_graph=True)
        gn = torch.sqrt(torch.sum(torch.square(g.reshape(g.shape[0], -1)), dim=1) + 1e-12)
        return torch.mean(torch.square(gn - 1.0))

    def train_step(self, real: torch.Tensor, step_idx: int = 0,
                   draws: Optional[Dict] = None) -> Dict[str, float]:
        c = self.cfg
        real = torch.as_tensor(real).to(self.device, next(self.gen.parameters()).dtype)
        if draws is None:
            draws = self.sample_draws(real.shape[0])
        dev, dt = self.device, real.dtype
        with no_tf32():
            with torch.no_grad():
                fake = self.gen(draws["z_d"].to(dev, dt))
            real_aug = apply_augment(real, draws["aug_real"])
            fake_aug = apply_augment(fake, draws["aug_fake"])
            (lr_main, lr_32), recon = self.disc(real_aug, decode=True)
            lf_main, lf_32 = self.disc(fake_aug)
            hinge_real = torch.mean(F.relu(1.0 - lr_main)) + torch.mean(F.relu(1.0 - lr_32))
            hinge_fake = torch.mean(F.relu(1.0 + lf_main)) + torch.mean(F.relu(1.0 + lf_32))
            with torch.no_grad():  # aux: reconstruct the downsized real image
                target = resize_square(real_aug, 32)
            recon_loss = torch.mean(torch.square(recon - target))
            d_loss = hinge_real + hinge_fake + c.recon_weight * recon_loss
            gp = torch.zeros((), device=dev, dtype=dt)
            if c.gp_weight > 0 and step_idx % c.gp_every == 0:
                gp = self._gp(real_aug)
                d_loss = d_loss + c.gp_weight * gp
            self.d_opt.step(torch.autograd.grad(d_loss, self.d_opt.params))

            fake = self.gen(draws["z_g"].to(dev, dt))
            lf_main, lf_32 = self.disc(apply_augment(fake, draws["aug_g"]))
            g_loss = -(torch.mean(lf_main) + torch.mean(lf_32))
            self.g_opt.step(torch.autograd.grad(g_loss, self.g_opt.params))
        with torch.no_grad():
            for e, p in zip(self.g_ema.parameters(), self.gen.parameters()):
                e.copy_(c.ema_decay * e + (1 - c.ema_decay) * p)
        parts = {"d_loss": d_loss, "g_loss": g_loss, "hinge_real": hinge_real,
                 "hinge_fake": hinge_fake, "recon": recon_loss, "gp": gp}
        return {k: float(v.detach()) for k, v in parts.items()}

    def generate(self, n: int, generator: Optional[torch.Generator] = None,
                 ema: bool = True) -> torch.Tensor:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        z = torch.randn((n, self.cfg.latent_dim), generator=g).to(self.device)
        with torch.no_grad(), no_tf32():
            return (self.g_ema if ema else self.gen)(z)

    def state(self) -> Dict:
        """The checkpoint payload: state dicts on the CPU and the widths."""
        cpu = lambda m: {k: v.detach().cpu() for k, v in m.state_dict().items()}  # noqa: E731
        c = self.cfg
        return {"g_ema": cpu(self.g_ema), "g": cpu(self.gen), "d": cpu(self.disc),
                "config": {"image_size": c.image_size, "latent_dim": c.latent_dim,
                           "fmap_max": c.fmap_max}}


def vgg_features(enc_params, x, device) -> np.ndarray:
    """Spatially pooled relu4_1 vectors, float32 numpy: the encoder on K3's
    float32 route."""
    from ccst_tpu_torch.models import vgg

    enc = vgg.prepare_params(enc_params, torch.float32, device)
    x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    with torch.no_grad():
        f = vgg.apply_encoder(enc, x.contiguous())
    return f.float().mean(dim=(1, 2)).cpu().numpy()


def frechet_distance(fa: np.ndarray, fb: np.ndarray) -> float:
    """|mu_a - mu_b|^2 + tr(Ca + Cb - 2 (Ca^1/2 Cb Ca^1/2)^1/2), the matrix
    square roots by symmetric eigendecomposition in float64."""
    mu_a, mu_b = fa.mean(0), fb.mean(0)
    ca = np.cov(fa, rowvar=False) + 1e-6 * np.eye(fa.shape[1])
    cb = np.cov(fb, rowvar=False) + 1e-6 * np.eye(fb.shape[1])

    def psd_sqrt(m):
        w, v = np.linalg.eigh(m)
        return (v * np.sqrt(np.clip(w, 0, None))) @ v.T

    sa = psd_sqrt(ca)
    mid = psd_sqrt(sa @ cb @ sa)
    d2 = float(np.sum((mu_a - mu_b) ** 2) + np.trace(ca + cb - 2 * mid))
    return max(d2, 0.0)


def vgg_frechet_distance(enc_params, a, b, device="cuda") -> float:
    """FID-style Frechet distance in VGG relu4_1 feature space (the upstream
    Trainer's ``calculate_fid`` with the framework's own encoder in place of
    InceptionV3; same ranking role, not comparable to Inception-FID)."""
    return frechet_distance(vgg_features(enc_params, a, device),
                            vgg_features(enc_params, b, device))


def save_augment_grid(images, out_path: str, generator: Optional[torch.Generator] = None,
                      policy: str = "color,translation,cutout") -> str:
    """Visual check of the DiffAugment policies: a grid PNG with one row per
    policy (the first row unaugmented), the counterpart of the upstream's
    DiffAugmentTest (lightweight_gan/diff_augment_test.py:26-52)."""
    from ccst_tpu_torch.data.loader import save_image_u8

    g = generator if generator is not None else torch.Generator().manual_seed(0)
    x = torch.as_tensor(np.asarray(images, np.float32))
    rows = [x.numpy()]
    for pol in _policy_names(policy):
        rows.append(diff_augment(g, x, pol).numpy())
    n, h, w, c = rows[0].shape
    grid = np.stack(rows).transpose(0, 2, 1, 3, 4).reshape(len(rows) * h, n * w, c)
    save_image_u8(np.clip(grid, 0.0, 1.0), out_path)
    return out_path
