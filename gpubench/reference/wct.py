"""Plain WCT universal style transfer (Li, Fang, Yang, Wang, Lu, Yang,
arXiv:1705.08086; the layers and the transform of PytorchWCT,
github.com/sunshineatnoon/PytorchWCT, after the authors' Torch7 code,
github.com/Yijunmaverick/UniversalStyleTransfer): the normalised VGG-19 cut
at relu5_1 .. relu1_1, one mirror decoder a level, and the whitening and
colouring transform, run coarse to fine, each level's decoded image encoded
again by the next level's encoder.

Convs in float32 with TF32 off, NCHW, ``F.conv2d`` after a reflection pad,
in blocks of images; the transform in float64 (as PytorchWCT computes it in
double): centred content features ``x_c``, ``C_c = x_c x_c^T / (n - 1) + I``,
``E_c D_c^-1/2 E_c^T`` over the eigenvalues above 1e-5 (all of them, with
``+ I``), then ``E_s D_s^1/2 E_s^T`` of the style covariance over its
eigenvalues above 1e-5, plus the style mean; alpha blends with the content
features. Departures from the paper's code:

- the style side is a domain's bank (CCST's premise: clients share
  statistics, never feature maps): the mean and covariance of every position
  of every style image of the domain at each level, summed in float64, with
  the divisor ``n - 1`` over all positions; the paper styles with one image;
- the decoded images pass between levels unclamped, as PytorchWCT passes
  them, and only the last is quantized as ``save_image`` does;
- eigenvalues come from ``torch.linalg.eigh`` (PytorchWCT calls
  ``torch.svd`` on the same symmetric matrices).

``quant``, ``store`` and ``operands`` select the output check's controls:
``"int8"`` rounds every conv's input and weights to int8 as
``reference/adain.py`` does; ``store`` a dtype rounds what the transform holds
to it (the centred features, their Gram, ``W_c``, the folded matrix ``S W``
and the product): a Gram and solve in that precision; ``operands`` a dtype
rounds the apply's two operands (``S W`` and the centred features) to it, the
sums exact: an apply in that precision. Each rounding scales by a power of
two into the dtype's range first.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from gpubench.reference import matmul_precision
from gpubench.reference.adain import Params, _walk, convs, to_u8

LEVELS = ("relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1")
EIG_CUT = 1e-5

# (name, cin, cout, kernel, relu), "pool" (2x2 max) and "up" (nearest 2x);
# a tap's level ends at the conv named in TAPS
ENCODER = (
    ("conv0", 3, 3, 1, False),
    ("conv1_1", 3, 64, 3, True), ("conv1_2", 64, 64, 3, True), "pool",
    ("conv2_1", 64, 128, 3, True), ("conv2_2", 128, 128, 3, True), "pool",
    ("conv3_1", 128, 256, 3, True), ("conv3_2", 256, 256, 3, True),
    ("conv3_3", 256, 256, 3, True), ("conv3_4", 256, 256, 3, True), "pool",
    ("conv4_1", 256, 512, 3, True), ("conv4_2", 512, 512, 3, True),
    ("conv4_3", 512, 512, 3, True), ("conv4_4", 512, 512, 3, True), "pool",
    ("conv5_1", 512, 512, 3, True),
)
TAPS = {"relu1_1": "conv1_1", "relu2_1": "conv2_1", "relu3_1": "conv3_1",
        "relu4_1": "conv4_1", "relu5_1": "conv5_1"}
_MIRROR = (
    ("dconv5_1", 512, 512, 3, True), "up",
    ("dconv4_4", 512, 512, 3, True), ("dconv4_3", 512, 512, 3, True),
    ("dconv4_2", 512, 512, 3, True), ("dconv4_1", 512, 256, 3, True), "up",
    ("dconv3_4", 256, 256, 3, True), ("dconv3_3", 256, 256, 3, True),
    ("dconv3_2", 256, 256, 3, True), ("dconv3_1", 256, 128, 3, True), "up",
    ("dconv2_2", 128, 128, 3, True), ("dconv2_1", 128, 64, 3, True), "up",
    ("dconv1_2", 64, 64, 3, True), ("dconv1_1", 64, 3, 3, False),
)


def _from(first: str):
    return _MIRROR[next(i for i, l in enumerate(_MIRROR) if l[0] == first):]


DECODERS = {"relu5_1": _MIRROR, "relu4_1": _from("dconv4_1"), "relu3_1": _from("dconv3_1"),
            "relu2_1": _from("dconv2_1"), "relu1_1": _from("dconv1_1")}


def encoder_to(level: str):
    end = TAPS[level]
    return ENCODER[:next(i for i, l in enumerate(ENCODER) if l[0] == end) + 1]


# the normalised VGG's first layer, a fixed 1x1 conv and no learned weight:
# RGB in [0, 1] to BGR in [0, 255] less the ImageNet BGR means, so that the
# features are on the scale the transform's +I assumes
CONV0_W = ((0.0, 0.0, 255.0), (0.0, 255.0, 0.0), (255.0, 0.0, 0.0))  # (out, in)
CONV0_B = (-103.939, -116.779, -123.68)


def make_weights(generator: torch.Generator, dec_scale: float, dec_shift: float
                 ) -> Tuple[Params, Dict[str, Params]]:
    """(encoder on to conv5_1, {level: decoder}), HWIO weights, float32 on the
    generator's device, drawn in one call as ``reference/adain.py`` draws
    them: weights uniform in +-sqrt(6 / fan in), biases in +-1/sqrt(fan in);
    ``conv0`` then set to its fixed layer (:data:`CONV0_W`, :data:`CONV0_B`);
    each decoder's last conv scaled by ``dec_scale``, its bias shifted by
    ``dec_shift``."""
    groups = [("enc", convs(ENCODER))] + [(lv, convs(DECODERS[lv])) for lv in LEVELS]
    sizes = [[k * k * cin * cout + cout for _, cin, cout, k, _ in layers]
             for _, layers in groups]
    u = torch.rand((sum(map(sum, sizes)),), generator=generator,
                   device=generator.device) * 2 - 1
    out, at = {}, 0
    for (group, layers), ns in zip(groups, sizes):
        params = {}
        for (name, cin, cout, k, _), n in zip(layers, ns):
            flat = u[at:at + n] * math.sqrt(1.0 / (cin * k * k))
            at += n
            params[name] = {"w": (flat[:-cout] * math.sqrt(6.0)).reshape(k, k, cin, cout)
                            .contiguous(), "b": flat[-cout:].contiguous()}
        if group != "enc":
            last = params["dconv1_1"]
            last["w"], last["b"] = last["w"] * dec_scale, last["b"] * dec_scale + dec_shift
        out[group] = params
    enc = out.pop("enc")
    dev = generator.device
    enc["conv0"] = {"w": torch.tensor(CONV0_W, device=dev).T.reshape(1, 1, 3, 3).contiguous(),
                    "b": torch.tensor(CONV0_B, device=dev)}
    return enc, out


def encode(enc: Params, images: torch.Tensor, level: str,
           quant: Optional[str] = None) -> torch.Tensor:
    """NCHW float32 images -> features at ``level``, NCHW float32."""
    return _walk(enc, images, encoder_to(level), quant)


def decode(dec: Params, feat: torch.Tensor, level: str, quant: Optional[str] = None
           ) -> torch.Tensor:
    """Features at ``level`` -> NCHW image, float32, unclamped."""
    return _walk(dec, feat, DECODERS[level], quant)


def rounded(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (none: as it is), scaled first by the power
    of two that puts its largest magnitude in the dtype's top binade (so
    that a narrow format rounds it at its full precision, not as
    subnormals)."""
    if dtype is None:
        return x
    amax = float(x.abs().max())
    shift = math.frexp(amax)[1] - math.frexp(torch.finfo(dtype).max)[1] + 1 if amax else 0
    return (x.float() * 2.0 ** -shift).to(dtype).to(x.dtype) * 2.0 ** shift


def colour_matrix(cov: torch.Tensor) -> torch.Tensor:
    """``E D^1/2 E^T`` of a float64 style covariance over its eigenvalues
    above ``EIG_CUT``."""
    e, v = torch.linalg.eigh(cov)
    keep = e > EIG_CUT
    return (v * torch.where(keep, e.clamp_min(0).sqrt(), torch.zeros_like(e))) @ v.T


class Bank:
    """A domain's second-order bank by level: float64 ``mean`` (C,), ``cov``
    (C, C), ``colour`` (C, C)."""

    def __init__(self, mean: Dict[str, torch.Tensor], cov: Dict[str, torch.Tensor]):
        self.mean, self.cov = mean, cov
        self.colour = {lv: colour_matrix(c) for lv, c in cov.items()}


def style_bank(enc: Params, images_u8: torch.Tensor, block: int,
               quant: Optional[str] = None) -> Bank:
    """Every position of every image, in float64 sums, at each level."""
    n = {lv: 0 for lv in LEVELS}
    s1: Dict[str, torch.Tensor] = {}
    s2: Dict[str, torch.Tensor] = {}
    with torch.no_grad(), matmul_precision(False):
        for i in range(0, images_u8.shape[0], block):
            x = images_u8[i:i + block].permute(0, 3, 1, 2).float() / 255.0
            for layer in ENCODER:
                x = _walk(enc, x, (layer,), quant)
                level = next((lv for lv, name in TAPS.items()
                              if not isinstance(layer, str) and layer[0] == name), None)
                if level is None:
                    continue
                f = x.double().transpose(0, 1).reshape(x.shape[1], -1)  # (C, N H W)
                n[level] += f.shape[1]
                s1[level] = s1.get(level, 0) + f.sum(dim=1)
                s2[level] = s2.get(level, 0) + f @ f.T
    mean = {lv: s1[lv] / n[lv] for lv in LEVELS}
    cov = {lv: (s2[lv] - n[lv] * torch.outer(mean[lv], mean[lv])) / (n[lv] - 1)
           for lv in LEVELS}
    return Bank(mean, cov)


def whitening(feat: torch.Tensor, store: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Content features (N, C, H, W) -> the centred features (N, C, HW) and
    ``W_c`` (N, C, C), float64; with ``store``, each rounded to it where the
    port stores it, and the Gram too (a lower-precision Gram and solve)."""
    n, c, h, w = feat.shape
    f = feat.double().reshape(n, c, h * w)
    xc = rounded(f - f.mean(dim=2, keepdim=True), store)
    cov = (rounded(xc @ xc.transpose(1, 2), store) / (h * w - 1)
           + torch.eye(c, dtype=f.dtype, device=f.device))
    e, v = torch.linalg.eigh(cov)
    d = torch.where(e > EIG_CUT, e.clamp_min(EIG_CUT).rsqrt(), torch.zeros_like(e))
    return xc, rounded((v * d[:, None, :]) @ v.transpose(1, 2), store)


def apply(feat: torch.Tensor, xc: torch.Tensor, wc: torch.Tensor, mean: torch.Tensor,
          colour: torch.Tensor, alpha: float, store: Optional[torch.dtype] = None,
          operands: Optional[torch.dtype] = None) -> torch.Tensor:
    """``whitening``'s ``xc`` and ``wc`` of content ``feat`` (N, C, H, W)
    coloured by one style's float64 ``mean`` and ``colour`` and blended by
    ``alpha``; float32 out."""
    t = rounded(rounded(colour @ wc, store), operands)
    out = rounded(t @ rounded(xc, operands), store) + mean[None, :, None]
    out = alpha * out + (1 - alpha) * feat.double().reshape(out.shape)
    return out.reshape(feat.shape).float()


def transform(feat: torch.Tensor, mean: torch.Tensor, colour: torch.Tensor, alpha: float,
              store: Optional[torch.dtype] = None,
              operands: Optional[torch.dtype] = None) -> torch.Tensor:
    """One level's WCT of content ``feat`` (N, C, H, W) under one style's
    float64 ``mean`` and ``colour``; float32 out."""
    xc, wc = whitening(feat, store)
    return apply(feat, xc, wc, mean, colour, alpha, store, operands)


def stylize(enc: Params, decs: Dict[str, Params], images_u8: torch.Tensor,
            banks: Sequence[Bank], block: int, alpha: float = 1.0,
            quant: Optional[str] = None, store: Optional[torch.dtype] = None,
            operands: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, H, W, 3) uint8 content under S banks -> (S, B, H, W, 3) uint8."""
    out: List[torch.Tensor] = []
    with torch.no_grad(), matmul_precision(False):
        for i in range(0, images_u8.shape[0], block):
            content = images_u8[i:i + block]
            per_style = []
            for bank in banks:
                img = content.permute(0, 3, 1, 2).float() / 255.0
                for lv in LEVELS:
                    f = encode(enc, img, lv, quant)
                    t = transform(f, bank.mean[lv], bank.colour[lv], alpha, store, operands)
                    img = decode(decs[lv], t, lv, quant)
                per_style.append(to_u8(img.permute(0, 2, 3, 1)))
            out.append(torch.stack(per_style))
    return torch.cat(out, dim=1)
