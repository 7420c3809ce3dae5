"""Plain AdaIN style transfer (Huang & Belongie, arXiv:1703.06868; the layers
of naoto0804/pytorch-AdaIN ``net.py``): the normalised VGG-19 to relu4_1,
AdaIN over per-channel style statistics, the mirror decoder, and the uint8
quantization of ``save_image``.

Float32 with TF32 off, NCHW, ``F.conv2d`` after a reflection pad, in blocks of
images. ``quant`` selects the output check's control: ``"int8"`` rounds every
conv's input to int8 with a per-tensor scale (max |x| / 127, taken at run time)
and its weights to int8 with a per-output-channel scale, as an int8 engine
would compute; ``None`` is the reference itself.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference import matmul_precision

# (name, cin, cout, kernel, relu), "pool" (2x2 max) and "up" (nearest 2x)
ENCODER = (
    ("conv0", 3, 3, 1, False),
    ("conv1_1", 3, 64, 3, True), ("conv1_2", 64, 64, 3, True), "pool",
    ("conv2_1", 64, 128, 3, True), ("conv2_2", 128, 128, 3, True), "pool",
    ("conv3_1", 128, 256, 3, True), ("conv3_2", 256, 256, 3, True),
    ("conv3_3", 256, 256, 3, True), ("conv3_4", 256, 256, 3, True), "pool",
    ("conv4_1", 256, 512, 3, True),
)
DECODER = (
    ("dconv4_1", 512, 256, 3, True), "up",
    ("dconv3_4", 256, 256, 3, True), ("dconv3_3", 256, 256, 3, True),
    ("dconv3_2", 256, 256, 3, True), ("dconv3_1", 256, 128, 3, True), "up",
    ("dconv2_2", 128, 128, 3, True), ("dconv2_1", 128, 64, 3, True), "up",
    ("dconv1_2", 64, 64, 3, True), ("dconv1_1", 64, 3, 3, False),
)
EPS = 1e-5
Params = Dict[str, Dict[str, torch.Tensor]]


def convs(arch) -> List[Tuple[str, int, int, int, bool]]:
    return [layer for layer in arch if not isinstance(layer, str)]


def make_weights(generator: torch.Generator, dec_scale: float, dec_shift: float
                 ) -> Tuple[Params, Params]:
    """(encoder, decoder), HWIO weights, float32 on the generator's device,
    drawn in one call: weights uniform in +-sqrt(6 / fan in) (He's bound,
    which keeps a ReLU network's signal from layer to layer), biases in
    +-1/sqrt(fan in) (torch Conv2d's). The last decoder conv is scaled by
    ``dec_scale`` and its bias shifted by ``dec_shift``, so that the images
    spread over [0, 1] and differ with their content; with torch's smaller
    default weight bound the signal dies out over the 18 convs and every image
    decodes to the same flat colours."""
    layers = convs(ENCODER) + convs(DECODER)
    sizes = [k * k * cin * cout + cout for _, cin, cout, k, _ in layers]
    u = torch.rand((sum(sizes),), generator=generator, device=generator.device) * 2 - 1
    params, at = {}, 0
    for (name, cin, cout, k, _), n in zip(layers, sizes):
        bound = math.sqrt(1.0 / (cin * k * k))
        flat = u[at:at + n] * bound
        at += n
        params[name] = {"w": (flat[:-cout] * math.sqrt(6.0)).reshape(k, k, cin, cout).contiguous(),
                        "b": flat[-cout:].contiguous()}
    last = params["dconv1_1"]
    last["w"], last["b"] = last["w"] * dec_scale, last["b"] * dec_scale + dec_shift
    enc = {name: params[name] for name, *_ in convs(ENCODER)}
    dec = {name: params[name] for name, *_ in convs(DECODER)}
    return enc, dec


def _fake_quant(x: torch.Tensor, dims, qmax: float) -> torch.Tensor:
    """Round to ``qmax`` levels a side with scale max |x| / qmax over all but
    ``dims``."""
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs().amax()
    s = amax / qmax + 1e-30
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


QMAX = {"int8": 127.0, "int4": 7.0}


def _conv(x: torch.Tensor, p, k: int, relu: bool, quant: Optional[str]) -> torch.Tensor:
    w = p["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    if quant:
        x = _fake_quant(x, (), QMAX[quant])
        w = _fake_quant(w, (1, 2, 3), QMAX[quant])
    if k == 3:
        x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    y = F.conv2d(x, w, p["b"])
    return torch.relu(y) if relu else y


def _walk(params: Params, x: torch.Tensor, arch, quant: Optional[str]) -> torch.Tensor:
    for layer in arch:
        if layer == "pool":
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        elif layer == "up":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        else:
            name, _, _, k, relu = layer
            x = _conv(x, params[name], k, relu, quant)
    return x


def encode(enc: Params, images_u8: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> relu4_1 features (N, 512, H/8, W/8), float32."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    return _walk(enc, x, ENCODER, quant)


def decode(dec: Params, feat: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """relu4_1-shaped features -> (N, H, W, 3) float32, unclamped."""
    return _walk(dec, feat, DECODER, quant).permute(0, 2, 3, 1)


def adain(feat: torch.Tensor, s_mean: torch.Tensor, s_std: torch.Tensor) -> torch.Tensor:
    """Per image and channel: standardize by the spatial mean and unbiased
    std (+ eps under the root), then take the style's (C,) statistics."""
    mean = feat.mean(dim=(2, 3), keepdim=True)
    std = torch.sqrt(feat.var(dim=(2, 3), keepdim=True, correction=1) + EPS)
    return (feat - mean) / std * s_std.view(1, -1, 1, 1) + s_mean.view(1, -1, 1, 1)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """``save_image``'s quantization: clamp to [0, 1], x 255, + 0.5, floor."""
    return torch.clamp(torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def population_stats(feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) a channel over every position of every feature map, with
    the population variance (+ eps under the root), in float64 sums."""
    n, s1, s2 = 0, 0.0, 0.0
    for f in feats:
        x = f.double().transpose(0, 1).reshape(f.shape[1], -1)
        n += x.shape[1]
        s1 = s1 + x.sum(dim=1)
        s2 = s2 + (x * x).sum(dim=1)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return mean.float(), torch.sqrt(var + EPS).float()


def style_bank(enc: Params, images_u8: torch.Tensor, block: int,
               quant: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A domain's style bank: the relu4_1 statistics over all its images."""
    with torch.no_grad(), matmul_precision(False):
        feats = [encode(enc, images_u8[i:i + block], quant)
                 for i in range(0, images_u8.shape[0], block)]
        return population_stats(feats)


def image_stats(enc: Params, image_u8: torch.Tensor, quant: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (1, H, W, 3) style image's relu4_1 statistics (population)."""
    with torch.no_grad(), matmul_precision(False):
        return population_stats([encode(enc, image_u8, quant)])


def stylize(enc: Params, dec: Params, images_u8: torch.Tensor, s_means: torch.Tensor,
            s_stds: torch.Tensor, block: int, quant: Optional[str] = None) -> torch.Tensor:
    """(B, H, W, 3) uint8 content under (S, C) style statistics ->
    (S, B, H, W, 3) uint8, alpha 1."""
    out = []
    with torch.no_grad(), matmul_precision(False):
        for i in range(0, images_u8.shape[0], block):
            feat = encode(enc, images_u8[i:i + block], quant)
            out.append(torch.stack([to_u8(decode(dec, adain(feat, m, s), quant))
                                    for m, s in zip(s_means, s_stds)]))
    return torch.cat(out, dim=1)
