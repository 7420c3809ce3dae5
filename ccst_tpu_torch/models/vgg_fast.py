"""The int8 engines of the VGG encoder / decoder (``int8-static``, ``int8-fused``).

Port of the int8-static half of ``ccst_tpu/models/vgg_fast.py``: the same
weights, re-mapped onto int8 programs that change how the arithmetic runs:

  - **packed level-1 stage.** The 64-channel convs at image resolution run in
    space-to-depth form, (H, W, C) -> (H/2, W/2, 4C) with phase-major
    channels, where the reflect-padded 3x3 conv is an edge-padded 3x3 conv
    with a 4x wider kernel (:func:`make_packed_kernel`); pool1 is the max over
    the phases and the last upsample folds into dconv1_2's kernel
    (:func:`sum_input_phases`).
  - **static int8.** One float32 calibration pass (:func:`calibrate_scales`)
    records max|input| of every conv. Weights are quantized per output channel
    and activations per tensor with those scales, so every conv's epilogue
    requantizes straight into the next conv's int8 input:
    ``acc * k + kb -> rint -> clip`` with ReLU as the clip's lower bound. The
    activations stay int8 from after conv0 to relu4_1 and from the AdaIN
    output to the image.

Every 3x3 conv goes through ``kernels/qconv.py`` (K0); ``int8-fused`` runs the
encoder's level-1 pair through ``kernels/level1.py`` (K1), with the same
output bits. The weight maths (packing, quantization, scale folding) is numpy,
formula for formula the JAX package's, so both packages quantize to the same
bits. The TPU-only pieces are gone: there is no ``interpret`` switch and no
row-tile rule with a silent fallback to the unfused chain.
"""
from __future__ import annotations

import json
import os
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ccst_tpu_torch.kernels.conv import _tensor, prepare_conv
from ccst_tpu_torch.kernels.level1 import (
    decoder_level1,
    encoder_level1,
    phase_max,
    prepare_decoder_level1,
    prepare_encoder_level1,
)
from ccst_tpu_torch.kernels.qconv import make_qconv, qconv3x3_s8
from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.ops.adain import adain_from_stats, alpha_blend

# layers computed in packed space (the level-1 stage at image resolution)
_PACKED_ENC = ("conv1_1", "conv1_2")
_PACKED_DEC = ("dconv1_2", "dconv1_1")

SCALES_FORMAT = "ccst_tpu/q8s_scales/v1"


# ---------------------------------------------------------------------------
# packed (space-to-depth) primitives
# ---------------------------------------------------------------------------


def pack_s2d(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), phase-major channels
    (packed channel index = (row_phase*2 + col_phase) * C + c)."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"packed engine needs even H, W; got {h}x{w}")
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c).contiguous()


def unpack_d2s(xp: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`pack_s2d`."""
    n, hb, wb, _ = xp.shape
    x = xp.reshape(n, hb, wb, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, hb * 2, wb * 2, c).contiguous()


def make_packed_kernel(w) -> np.ndarray:
    """(3, 3, Cin, Cout) conv kernel -> its packed-space equivalent
    (3, 3, 4Cin, 4Cout).

    Output phase (a, b) at packed position (i, j) is original position
    (2i+a, 2j+b); each original tap (dy, dx) lands at packed tap (R+1, C+1) on
    input phase (ar, ac) where a+dy-1 = 2R+ar (likewise columns). Taps outside
    a phase's window stay zero, which is what makes EDGE padding of the packed
    tensor equal to REFLECT padding of the original plane."""
    wn = np.asarray(w, np.float32)
    cin, cout = wn.shape[2], wn.shape[3]
    K = np.zeros((3, 3, 4 * cin, 4 * cout), np.float32)
    for a in (0, 1):
        for b in (0, 1):
            for dy in range(3):
                for dx in range(3):
                    r, c = a + dy - 1, b + dx - 1
                    R, ar = r // 2, r % 2
                    C, ac = c // 2, c % 2
                    K[
                        R + 1,
                        C + 1,
                        (ar * 2 + ac) * cin : (ar * 2 + ac + 1) * cin,
                        (a * 2 + b) * cout : (a * 2 + b + 1) * cout,
                    ] = wn[dy, dx]
    return K


def sum_input_phases(K: np.ndarray, cin: int) -> np.ndarray:
    """Fold a nearest-2x upsample INTO a packed kernel: every input phase of an
    upsampled tensor equals the small tensor, so the phase groups of the
    kernel sum, (3, 3, 4cin, 4cout) -> (3, 3, cin, 4cout)."""
    k = np.asarray(K, np.float32)
    return sum(
        k[:, :, p * cin : (p + 1) * cin, :] for p in range(4)
    )


def _packed_kernel_for(name: str, w) -> np.ndarray:
    """Packed kernel for layer ``name``; dconv1_2 consumes a nearest-2x
    upsample, which folds into its kernel."""
    K = make_packed_kernel(w)
    if name == "dconv1_2":
        K = sum_input_phases(K, np.shape(w)[2])
    return K


# ---------------------------------------------------------------------------
# int8-static preparation
# ---------------------------------------------------------------------------


def cast_params(params, dtype: torch.dtype) -> Dict[str, Dict[str, np.ndarray]]:
    """float32 numpy copies of every weight and bias, rounded through ``dtype``
    (the JAX engine casts its weights to the compute dtype before it
    quantizes or calibrates with them). Values may be tensors or arrays."""
    return {
        name: {kind: _tensor(p[kind]).cpu().to(dtype).float().numpy() for kind in ("w", "b")}
        for name, p in params.items()
    }


def _quantize_kernel(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    w = np.asarray(w, np.float32)
    scale = np.abs(w).max(axis=(0, 1, 2)) / 127.0 + 1e-30
    wq = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return wq, np.asarray(scale, np.float32)


def quantize_static(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``rint(x * (1 / scale))`` clipped to [-127, 127], int8. The reciprocal
    is rounded once to float32, as JAX's weak-typed Python float is; it stays
    a Python number (a float32 tensor times a number is a float32 product), so
    that no call copies a scalar to the device: such a copy cannot be captured
    into a CUDA graph."""
    inv = float(np.float32(1.0 / scale))
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


_ENC_NEXT = {  # conv -> the conv consuming its output (requant target)
    "conv1_1": "conv1_2", "conv1_2": "conv2_1", "conv2_1": "conv2_2",
    "conv2_2": "conv3_1", "conv3_1": "conv3_2", "conv3_2": "conv3_3",
    "conv3_3": "conv3_4", "conv3_4": "conv4_1", "conv4_1": None,
}
_DEC_NEXT = {
    "dconv4_1": "dconv3_4", "dconv3_4": "dconv3_3", "dconv3_3": "dconv3_2",
    "dconv3_2": "dconv3_1", "dconv3_1": "dconv2_2", "dconv2_2": "dconv2_1",
    "dconv2_1": "dconv1_2", "dconv1_2": "dconv1_1", "dconv1_1": None,
}


def _prepare_q8s(
    params, scales: Dict[str, float], next_map: Dict[str, Optional[str]],
    packed_names: Sequence[str], dtype: torch.dtype, device,
) -> Dict[str, Any]:
    prep: Dict[str, Any] = {"__scales__": dict(scales)}
    for name, p in params.items():
        if name == "conv0":
            prep[name] = prepare_conv(p["w"], p["b"], dtype, device)
            continue
        packed = name in packed_names
        wq, ws = _quantize_kernel(
            _packed_kernel_for(name, p["w"]) if packed
            else np.asarray(p["w"], np.float32)
        )
        in_s = scales[name] / 127.0
        nxt = next_map[name]
        b = np.asarray(p["b"], np.float32)
        if packed:
            b = np.tile(b, 4)
        k = np.asarray(ws, np.float32) * in_s
        if nxt is None:  # dequantized output
            prep[name] = make_qconv(wq, k, b, packed, False, device)
        else:
            out_s = scales[nxt] / 127.0
            prep[name] = make_qconv(wq, k / out_s, b / out_s, packed, True, device)
    return prep


def prepare_encoder_q8s(params, scales: Dict[str, float], dtype=torch.bfloat16, device="cpu"):
    """``params``: :func:`cast_params` output for ``dtype``. ``"__level1__"``
    holds conv1_1 / conv1_2 once more, in the fused level-1 kernel's layouts."""
    prep = _prepare_q8s(params, scales, _ENC_NEXT, _PACKED_ENC, dtype, device)
    prep["__level1__"] = prepare_encoder_level1(prep["conv1_1"], prep["conv1_2"])
    return prep


def prepare_decoder_q8s(params, scales: Dict[str, float], dtype=torch.bfloat16, device="cpu"):
    """``params``: :func:`cast_params` output for ``dtype``. ``"__level1__"``
    holds dconv1_2 / dconv1_1 once more, in the fused level-1 kernel's layouts."""
    prep = _prepare_q8s(params, scales, _DEC_NEXT, _PACKED_DEC, dtype, device)
    prep["__level1__"] = prepare_decoder_level1(prep["dconv1_2"], prep["dconv1_1"])
    return prep


# ---------------------------------------------------------------------------
# int8-static / int8-fused apply
# ---------------------------------------------------------------------------


def _encode(prep: Dict, images: torch.Tensor, dtype: torch.dtype, fused: bool) -> torch.Tensor:
    x = vgg.conv1x1(images.to(dtype), prep["conv0"])  # 1x1 RGB rescale, no relu
    xq = pack_s2d(quantize_static(x, prep["__scales__"]["conv1_1"] / 127.0))
    if fused:
        xq = encoder_level1(xq, prep["conv1_1"], prep["conv1_2"], prep["__level1__"])
    else:
        xq = qconv3x3_s8(xq, prep["conv1_1"], True, dtype, "edge")
        xq = qconv3x3_s8(xq, prep["conv1_2"], True, dtype, "edge")
        xq = phase_max(xq, 64)  # int8 max == max on the shared scale
    pools_seen = 0
    for layer in vgg.ENCODER_ARCH:
        if isinstance(layer, vgg.Conv) and layer.name not in ("conv0", *_PACKED_ENC):
            xq = qconv3x3_s8(xq, prep[layer.name], layer.relu, dtype, "reflect")
            if layer.name == "conv4_1":
                return xq  # dequantized relu4_1 features in dtype
        elif isinstance(layer, vgg.Pool):
            pools_seen += 1
            if pools_seen > 1:  # pool1 was the phase max
                xq = vgg.maxpool_ceil(xq)
    return xq


def _dec_mid_layers():
    """Decoder layers before the packed level-1 stage, without the upsample
    that folds into dconv1_2."""
    out = []
    for layer in vgg.DECODER_ARCH:
        if isinstance(layer, vgg.Conv) and layer.name in _PACKED_DEC:
            break
        out.append(layer)
    assert isinstance(out[-1], vgg.Upsample)
    return tuple(out[:-1])


_DEC_MID = _dec_mid_layers()


def _decode(prep: Dict, feat: torch.Tensor, dtype: torch.dtype, fused: bool) -> torch.Tensor:
    xq = quantize_static(feat, prep["__scales__"]["dconv4_1"] / 127.0)
    for layer in _DEC_MID:
        if isinstance(layer, vgg.Conv):
            xq = qconv3x3_s8(xq, prep[layer.name], layer.relu, dtype, "reflect")
        elif isinstance(layer, vgg.Upsample):
            xq = vgg.upsample_nearest2x(xq)
    if fused:
        y = decoder_level1(xq, prep["dconv1_2"], prep["dconv1_1"], dtype, prep["__level1__"])
    else:
        xq = qconv3x3_s8(xq, prep["dconv1_2"], True, dtype, "edge")
        y = qconv3x3_s8(xq, prep["dconv1_1"], False, dtype, "edge")
    return unpack_d2s(y, 3)


def apply_encoder_q8s(prep: Dict, images: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """int8-static encoder: images (N, H, W, 3) in [0, 1], H and W even ->
    relu4_1 features in ``dtype``; quantized once after conv0, int8 until
    conv4_1's dequant."""
    return _encode(prep, images, dtype, fused=False)


def apply_encoder_q8s_fused(prep: Dict, images: torch.Tensor, dtype=torch.bfloat16):
    """:func:`apply_encoder_q8s` with conv1_1 + conv1_2 + pool1 as one kernel
    (K1); the same output bits."""
    return _encode(prep, images, dtype, fused=True)


def apply_decoder_q8s(prep: Dict, feat: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """int8-static decoder: AdaIN features -> image in ``dtype``; quantized
    once, int8 until dconv1_1's dequant."""
    return _decode(prep, feat, dtype, fused=False)


def apply_decoder_q8s_fused(prep: Dict, feat: torch.Tensor, dtype=torch.bfloat16):
    """:func:`apply_decoder_q8s` with dconv1_2 + dconv1_1 as one kernel (K2);
    the same output bits."""
    return _decode(prep, feat, dtype, fused=True)


# ---------------------------------------------------------------------------
# calibration and its persistence
# ---------------------------------------------------------------------------


@contextmanager
def _no_tf32():
    """float32 convs and matmuls in full float32 on the card (cuDNN convs
    default to TF32), restored afterwards."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _conv_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reflect-padded (3x3) or unpadded (1x1) float32 conv + bias, NHWC."""
    xn = x.permute(0, 3, 1, 2)
    if w.shape[0] == 3:
        xn = F.pad(xn, (1, 1, 1, 1), mode="reflect")
    out = F.conv2d(xn, w.permute(3, 2, 0, 1)) + b.view(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1)


@torch.no_grad()
def calibrate_scales(
    enc_params, dec_params, images: torch.Tensor,
    style_stats: Optional[Sequence[Tuple[Any, Any]]] = None, alpha: float = 1.0,
) -> Dict[str, float]:
    """One float32 reference pass over a calibration batch (and style bank),
    recording max|input| of every conv, the decoder's under every style.
    Keyed by the conv whose INPUT the scale quantizes. Packing is a
    permutation, so calibrating on the unpacked path is exact for the packed
    layers too. ``*_params``: :func:`cast_params` output; ``images`` (N, H, W,
    3) in [0, 1] on the device to calibrate on."""
    dev = images.device

    def on_dev(params):
        return {n: {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
                for n, p in params.items()}

    enc, dec = on_dev(enc_params), on_dev(dec_params)
    if not style_stats:  # None or empty: unit-stats fallback
        c = enc["conv4_1"]["b"].shape[0]
        style_stats = [(np.zeros((c,), np.float32), np.ones((c,), np.float32))]
    scales: Dict[str, torch.Tensor] = {}
    with _no_tf32():
        x = images.float()
        for layer in vgg.ENCODER_ARCH:
            if isinstance(layer, vgg.Conv):
                p = enc[layer.name]
                if layer.name != "conv0":
                    scales[layer.name] = x.abs().max()
                x = _conv_f32(x, p["w"], p["b"])
                if layer.relu:
                    x = torch.relu(x)
                if layer.name == "conv4_1":
                    break
            elif isinstance(layer, vgg.Pool):
                x = vgg.maxpool_ceil(x)
        feat = x
        for s_mean, s_std in style_stats:
            t = adain_from_stats(feat, s_mean, s_std)
            y = alpha_blend(t, feat, alpha)
            for layer in vgg.DECODER_ARCH:
                if isinstance(layer, vgg.Conv):
                    m = y.abs().max()
                    prev = scales.get(layer.name)
                    scales[layer.name] = m if prev is None else torch.maximum(prev, m)
                    p = dec[layer.name]
                    y = _conv_f32(y, p["w"], p["b"])
                    if layer.relu:
                        y = torch.relu(y)
                elif isinstance(layer, vgg.Upsample):
                    y = vgg.upsample_nearest2x(y)
    return {k: float(v) for k, v in scales.items()}


def weights_fingerprint(enc_params, dec_params) -> str:
    """Fingerprint of the (encoder, decoder) weight pair, stored in the scales
    file so that a calibration is never applied to other weights; the text of
    ``ccst_tpu`` ``vgg_fast.weights_fingerprint``. Per net: the plain and the
    layer-position-weighted sum of |w| over every conv and a weighted
    mid-element probe, over the bfloat16-cast weights, sums in float32, each
    rounded to 4 significant digits."""

    def net_sig(params):
        total = weighted = probe = 0.0
        for i, name in enumerate(sorted(params)):
            w = _tensor(params[name]["w"]).cpu().to(torch.bfloat16).float()
            si = float(f"{float(w.abs().sum()):.4g}")
            total += si
            weighted += (i + 1) * si
            probe += (i + 1) * float(w.reshape(-1)[w.numel() // 2])
        return total, weighted, probe

    parts = [*net_sig(enc_params), *net_sig(dec_params)]
    return ",".join(f"{v:.4g}" for v in parts)


def save_scales(path: str, scales: Dict[str, float], fingerprint: str = "") -> str:
    """Write int8-static calibration scales (JSON: conv name -> max|input|),
    in the ``ccst_tpu/q8s_scales/v1`` format that both packages read; the
    double round-trip is exact. ``fingerprint`` ties the file to its weights."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"format": SCALES_FORMAT, "scales": scales}
    if fingerprint:
        payload["weights_fingerprint"] = fingerprint
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_scales(path: str, expect_fingerprint: str = "") -> Dict[str, float]:
    """Scales written by :func:`save_scales` (or ``ccst_tpu``'s). Raises
    ValueError when ``expect_fingerprint`` is given and the file carries a
    different one; files without a fingerprint load unconditionally."""
    with open(path) as f:
        obj = json.load(f)
    if obj.get("format") != SCALES_FORMAT:
        raise ValueError(f"{path}: not a ccst_tpu q8s scales artifact")
    stored = obj.get("weights_fingerprint", "")
    if expect_fingerprint and stored and stored != expect_fingerprint:
        raise ValueError(
            f"{path}: calibration was made for different weights "
            f"(artifact fingerprint {stored!r} != current "
            f"{expect_fingerprint!r}); re-run `calibrate`"
        )
    return {k: float(v) for k, v in obj["scales"].items()}
