"""The int8-static stylizer's maths, frozen here as a plain copy of
``ccst_tpu_torch/models/vgg_fast.py`` (int8-static / int8-fused, bfloat16
around the int8 chain), without its packed layouts or kernels.

- Weights are rounded through bfloat16 first, as the engine's ``cast_params``.
- Calibration: one float32 pass (TF32 off) over the calibration images and
  every style bank records max |input| of each 3x3 conv, the decoder's the
  largest over the banks.
- Weights are quantized per output channel (max |w| / q), activations per
  tensor with the calibrated scale (x times the float32 reciprocal of
  max / q, rounded half to even, clipped to +-q). Each conv sums its integer
  products exactly (float64) and runs the epilogue ``acc * k + kb`` as two
  float32 operations: a requant into the next conv's integers (ReLU as the
  clip's lower bound), or, at conv4_1 and dconv1_1, a dequant to bfloat16.
  Pools and upsamples act on the integers. Packing into space-to-depth form,
  which the engines use for the level-1 stage, is a permutation and changes
  no sum.
- conv0 (1x1) runs in float32 on the bfloat16 image and rounds to bfloat16;
  AdaIN runs on the bfloat16 features in float32 and rounds to bfloat16.

``bits=4`` puts q = 7 in place of 127 everywhere: the output check's control.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference import matmul_precision
from gpubench.reference.adain import DECODER, ENCODER, Params, adain, convs, to_u8

_ENC = [name for name, *_ in convs(ENCODER)]
_DEC = [name for name, *_ in convs(DECODER)]


def cast_bf16(params: Params) -> Params:
    return {n: {k: v.to(torch.bfloat16).float() for k, v in p.items()} for n, p in params.items()}


def _conv_f32(x: torch.Tensor, p, k: int) -> torch.Tensor:
    w = p["w"].permute(3, 2, 0, 1)
    if k == 3:
        x = F.pad(x, (1, 1, 1, 1), mode="reflect")
    return F.conv2d(x, w, p["b"])


@torch.no_grad()
def calibrate(enc: Params, dec: Params, images_u8: torch.Tensor,
              banks: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> Dict[str, float]:
    """max |input| of every 3x3 conv, keyed by that conv (``enc``, ``dec``:
    bfloat16-rounded weights)."""
    scales: Dict[str, torch.Tensor] = {}
    with matmul_precision(False):
        x = images_u8.permute(0, 3, 1, 2).float() / 255.0
        for layer in ENCODER:
            if layer == "pool":
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
                continue
            name, _, _, k, relu = layer
            if name != "conv0":
                scales[name] = x.abs().max()
            x = _conv_f32(x, enc[name], k)
            x = torch.relu(x) if relu else x
        for s_mean, s_std in banks:
            y = adain(x, s_mean, s_std)
            for layer in DECODER:
                if layer == "up":
                    y = F.interpolate(y, scale_factor=2, mode="nearest")
                    continue
                name, _, _, k, relu = layer
                m = y.abs().max()
                scales[name] = m if name not in scales else torch.maximum(scales[name], m)
                y = _conv_f32(y, dec[name], k)
                y = torch.relu(y) if relu else y
    return {k: float(v) for k, v in scales.items()}


class QLayer:
    """One int8 conv: integer weights (OIHW, float64), the float32 epilogue
    ``k``, ``kb`` and whether it requantizes."""

    def __init__(self, wq, k, kb, requant: bool, device):
        self.wq = torch.from_numpy(wq.astype(np.float64)).permute(3, 2, 0, 1).to(device)
        self.k = torch.from_numpy(k).to(device)
        self.kb = torch.from_numpy(kb).to(device)
        self.requant = requant


def _prepare(params: Params, scales: Dict[str, float], names: List[str], q: float,
             device) -> Dict[str, QLayer]:
    out = {}
    for i, name in enumerate(names):
        w = params[name]["w"].cpu().numpy().astype(np.float32)
        b = params[name]["b"].cpu().numpy().astype(np.float32)
        ws = np.abs(w).max(axis=(0, 1, 2)) / np.float32(q) + np.float32(1e-30)
        wq = np.clip(np.rint(w / ws), -q, q)
        in_s = scales[name] / q
        k = ws * np.float32(in_s)
        nxt = names[i + 1] if i + 1 < len(names) else None
        if nxt is None:
            out[name] = QLayer(wq, k, b, False, device)
        else:
            out_s = np.float32(scales[nxt] / q)
            out[name] = QLayer(wq, k / out_s, b / out_s, True, device)
    return out


class Int8Static:
    """The int8-static encoder and decoder for one set of weights and scales."""

    def __init__(self, enc: Params, dec: Params, scales: Dict[str, float], bits: int = 8):
        self.q = {8: 127.0, 4: 7.0}[bits]
        dev = enc["conv0"]["w"].device
        self.scales = scales
        self.conv0 = enc["conv0"]
        self.enc = _prepare(enc, scales, _ENC[1:], self.q, dev)
        self.dec = _prepare(dec, scales, _DEC, self.q, dev)

    def _quantize(self, x: torch.Tensor, name: str) -> torch.Tensor:
        inv = float(np.float32(1.0 / (self.scales[name] / self.q)))
        return torch.clamp(torch.round(x.float() * inv), -self.q, self.q)

    def _qconv(self, x: torch.Tensor, layer: QLayer, relu: bool) -> torch.Tensor:
        acc = F.conv2d(F.pad(x.double(), (1, 1, 1, 1), mode="reflect"), layer.wq).float()
        y = acc * layer.k.view(1, -1, 1, 1)
        y = y + layer.kb.view(1, -1, 1, 1)
        if layer.requant:
            return torch.clamp(torch.round(y), 0.0 if relu else -self.q, self.q)
        return (torch.clamp_min(y, 0.0) if relu else y).to(torch.bfloat16)

    def _walk(self, x: torch.Tensor, arch, layers: Dict[str, QLayer]) -> torch.Tensor:
        for layer in arch:
            if layer == "pool":
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            elif layer == "up":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif layer[0] != "conv0":
                x = self._qconv(x, layers[layer[0]], layer[4])
        return x

    def encode(self, images_u8: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> relu4_1 features, bfloat16 NCHW."""
        x = (images_u8.permute(0, 3, 1, 2).float() / 255.0).to(torch.bfloat16).float()
        w = self.conv0["w"].reshape(3, 3)
        x = torch.einsum("nchw,cd->ndhw", x, w) + self.conv0["b"].view(1, -1, 1, 1)
        x = self._quantize(x.to(torch.bfloat16), "conv1_1")
        return self._walk(x, ENCODER, self.enc)

    def decode(self, feat_bf16: torch.Tensor) -> torch.Tensor:
        """AdaIN output (bfloat16 NCHW) -> (N, H, W, 3) float32 image."""
        x = self._quantize(feat_bf16, "dconv4_1")
        return self._walk(x, DECODER, self.dec).float().permute(0, 2, 3, 1)


def stylize(model: Int8Static, images_u8: torch.Tensor, s_means: torch.Tensor,
            s_stds: torch.Tensor, block: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 content under (S, C) banks -> (S, B, H, W, 3) uint8."""
    out = []
    with torch.no_grad(), matmul_precision(False):
        for i in range(0, images_u8.shape[0], block):
            feat = model.encode(images_u8[i:i + block]).float()
            out.append(torch.stack([
                to_u8(model.decode(adain(feat, m, s).to(torch.bfloat16)))
                for m, s in zip(s_means, s_stds)]))
    return torch.cat(out, dim=1)
