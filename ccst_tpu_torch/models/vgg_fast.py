"""The fast engines of the VGG encoder / decoder: ``packed``, ``int8``,
``int8-static`` and ``int8-fused``.

Port of ``ccst_tpu/models/vgg_fast.py``: the same weights, re-mapped onto
programs that change how the arithmetic runs:

  - **packed level-1 stage.** The 64-channel convs at image resolution run in
    space-to-depth form, (H, W, C) -> (H/2, W/2, 4C) with phase-major
    channels, where the reflect-padded 3x3 conv is an edge-padded 3x3 conv
    with a 4x wider kernel (:func:`make_packed_kernel`); pool1 is the max over
    the phases and the last upsample folds into dconv1_2's kernel
    (:func:`sum_input_phases`).
  - **packed** (bf16, exact to float tolerance): the packed stage through K3
    in edge mode (``kernels/conv.py``), every other conv as in ``ref``.
  - **int8** (dynamic scales): every conv quantizes its input per tensor at
    run time (:func:`_quantize_act`: ``max|x|``, then ``x / s`` rounded), runs
    K0 (``kernels/qconv.py``) with int32 sums and dequantizes with
    ``w_scale * a_scale``, a product formed on the device, never read by the
    host; the packed stage with edge padding, the rest with reflect padding.
  - **static int8.** One float32 calibration pass (:func:`calibrate_scales`)
    records max|input| of every conv. Weights are quantized per output channel
    and activations per tensor with those scales, so every conv's epilogue
    requantizes straight into the next conv's int8 input:
    ``acc * k + kb -> rint -> clip`` with ReLU as the clip's lower bound. The
    activations stay int8 from after conv0 to relu4_1 and from the AdaIN
    output to the image.

Every int8 3x3 conv goes through K0; ``int8-fused`` runs the encoder's
level-1 pair through ``kernels/level1.py`` (K1) and the decoder's through K2,
with the same output bits as ``int8-static``. The weight maths (packing,
quantization, scale folding) is numpy, formula for formula the JAX package's,
so both packages quantize to the same bits. The TPU-only pieces are gone:
there is no ``interpret`` switch and no row-tile rule with a silent fallback
to the unfused chain.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ccst_tpu_torch.kernels.conv import ConvWeights, _tensor, prepare_conv, reflect_conv3x3
from ccst_tpu_torch.kernels.level1 import (
    decoder_level1,
    encoder_level1,
    phase_max,
    prepare_decoder_level1,
    prepare_encoder_level1,
)
from ccst_tpu_torch.kernels.qconv import QConvS, make_qconv, qconv3x3_s8
from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.ops.adain import adain_from_stats, alpha_blend
from ccst_tpu_torch.utils.precision import no_tf32

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
# the encoder after pool1, which the packed stage takes as its phase max
_ENC_TAIL = vgg.ENCODER_ARCH[
    next(i for i, layer in enumerate(vgg.ENCODER_ARCH) if isinstance(layer, vgg.Pool)) + 1:]


def _walk(layers: Sequence, x: torch.Tensor, conv) -> torch.Tensor:
    """``layers`` (a slice of a VGG spec) with every conv as ``conv(x, layer)``,
    the ceil-mode pools and the nearest 2x upsamples."""
    for layer in layers:
        if isinstance(layer, vgg.Conv):
            x = conv(x, layer)
        elif isinstance(layer, vgg.Pool):
            x = vgg.maxpool_ceil(x)
        elif isinstance(layer, vgg.Upsample):
            x = vgg.upsample_nearest2x(x)
    return x


# ---------------------------------------------------------------------------
# bf16 packed engine (exact)
# ---------------------------------------------------------------------------

# The packed conv1_1 takes its 12 input channels padded with zeros to 16: a
# 16-channel bf16 pixel is 32 bytes, which K3's wgmma route copies 16 bytes at
# a time, where 12 channels (24 bytes) take its scalar-gather route. The zero
# channels meet zero weights, so the sums are the same.
PACKED_CIN = 16


def _prepare_packed(params, names: Sequence[str], dtype: torch.dtype,
                    device) -> Dict[str, ConvWeights]:
    out = {}
    for name, p in params.items():
        w, b = np.asarray(p["w"], np.float32), np.asarray(p["b"], np.float32)
        if name in names:
            w, b = _packed_kernel_for(name, w), np.tile(b, 4)
            if name == "conv1_1":
                w = np.pad(w, ((0, 0), (0, 0), (0, PACKED_CIN - w.shape[2]), (0, 0)))
        out[name] = prepare_conv(w, b, dtype, device)
    return out


def prepare_encoder(params, dtype=torch.bfloat16, device="cpu") -> Dict[str, ConvWeights]:
    """The packed engine's encoder: ``params`` (:func:`cast_params` output for
    ``dtype``) with conv1_1 / conv1_2 as packed kernels."""
    return _prepare_packed(params, _PACKED_ENC, dtype, device)


def prepare_decoder(params, dtype=torch.bfloat16, device="cpu") -> Dict[str, ConvWeights]:
    """The packed engine's decoder: dconv1_2 (upsample folded in) and dconv1_1
    as packed kernels."""
    return _prepare_packed(params, _PACKED_DEC, dtype, device)


def packed_reflect_conv(xp: torch.Tensor, cw: ConvWeights, relu: bool = True) -> torch.Tensor:
    """Packed-space equivalent of reflect-pad + 3x3 conv + bias (+ ReLU): K3
    with edge padding on the packed plane."""
    return reflect_conv3x3(xp, cw, relu, "edge")


def apply_encoder_packed(prep: Dict, images: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Images (N, H, W, 3) in [0, 1], H and W even -> relu4_1 features; the
    ``ref`` encoder with the level-1 stage computed in packed space."""
    x = vgg.conv1x1(images.to(dtype), prep["conv0"])  # 1x1 RGB rescale, no relu
    xp = pack_s2d(x)  # (N, H/2, W/2, 12)
    xp = F.pad(xp, (0, prep["conv1_1"].w.shape[2] - xp.shape[3]))
    xp = packed_reflect_conv(xp, prep["conv1_1"])
    xp = packed_reflect_conv(xp, prep["conv1_2"])
    return _walk(_ENC_TAIL, phase_max(xp, 64),
                 lambda t, layer: reflect_conv3x3(t, prep[layer.name], layer.relu))


def apply_decoder_packed(prep: Dict, feat: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """relu4_1 features -> image; the ``ref`` decoder with the last upsample,
    dconv1_2 and dconv1_1 computed in packed space."""
    x = _walk(_DEC_MID, feat.to(dtype),
              lambda t, layer: reflect_conv3x3(t, prep[layer.name], layer.relu))
    xp = packed_reflect_conv(x, prep["dconv1_2"])  # the upsample is in its kernel
    xp = packed_reflect_conv(xp, prep["dconv1_1"], relu=False)
    return unpack_d2s(xp, 3)


# ---------------------------------------------------------------------------
# int8 engine (dynamic per-tensor activation scales)
# ---------------------------------------------------------------------------


def _quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor dynamic int8 (``ccst_tpu`` ``vgg_fast._quantize_act``): ``s =
    max|x| / 127 + 1e-30`` in float32, then ``x / s`` rounded half to even and
    clipped to [-127, 127]. Both divisions are true divisions, as XLA's: the
    127 is a tensor on x's device, since PyTorch on the card turns a division
    by a Python number into a product with its reciprocal. ``s`` stays a 0-d
    tensor on x's device: nothing is read back to the host."""
    xf = x.float()
    amax = xf.abs().amax()
    s = amax / torch.full_like(amax, 127.0) + 1e-30
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _qconv_apply(x: torch.Tensor, q: QConvS, relu: bool, out_dtype: torch.dtype,
                 pad_mode: str) -> torch.Tensor:
    """One conv of the dynamic engine: quantize the input, then K0 with int32
    sums and the dequant ``acc * (w_scale * a_scale) + bias`` (optional ReLU)
    into ``out_dtype``. The multiplier is one float32 product on the device,
    rounded once as XLA rounds it; K0 takes it as its per-channel ``k``."""
    xq, a_scale = _quantize_act(x)
    return qconv3x3_s8(xq, q._replace(k=q.k * a_scale), relu, out_dtype, pad_mode)


def _prepare_q8(params, packed_names: Sequence[str], dtype: torch.dtype, device) -> Dict[str, Any]:
    """``ccst_tpu``'s ``QConv`` as a dequantizing :class:`QConvS`: ``k`` the
    per-output-channel weight scale (packed layers: per packed channel), ``kb``
    the bias (tiled over the phases where packed)."""
    prep: Dict[str, Any] = {}
    for name, p in params.items():
        if name == "conv0":
            prep[name] = prepare_conv(p["w"], p["b"], dtype, device)  # 1x1, in dtype
            continue
        packed = name in packed_names
        wq, ws = _quantize_kernel(
            _packed_kernel_for(name, p["w"]) if packed else np.asarray(p["w"], np.float32)
        )
        b = np.asarray(p["b"], np.float32)
        prep[name] = make_qconv(wq, ws, np.tile(b, 4) if packed else b, packed, False, device)
    return prep


def prepare_encoder_q8(params, dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """``params``: :func:`cast_params` output for ``dtype``."""
    return _prepare_q8(params, _PACKED_ENC, dtype, device)


def prepare_decoder_q8(params, dtype=torch.bfloat16, device="cpu") -> Dict[str, Any]:
    """``params``: :func:`cast_params` output for ``dtype``."""
    return _prepare_q8(params, _PACKED_DEC, dtype, device)


def apply_encoder_q8(prep: Dict, images: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dynamic int8 encoder: images (N, H, W, 3) in [0, 1], H and W even ->
    relu4_1 features in ``dtype``; every conv's output in ``dtype``."""
    x = vgg.conv1x1(images.to(dtype), prep["conv0"])
    xp = _qconv_apply(pack_s2d(x), prep["conv1_1"], True, dtype, "edge")
    xp = _qconv_apply(xp, prep["conv1_2"], True, dtype, "edge")
    return _walk(_ENC_TAIL, phase_max(xp, 64), lambda t, layer: _qconv_apply(
        t, prep[layer.name], layer.relu, dtype, "reflect"))


def apply_decoder_q8(prep: Dict, feat: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dynamic int8 decoder: AdaIN features -> image in ``dtype``."""
    x = _walk(_DEC_MID, feat.to(dtype), lambda t, layer: _qconv_apply(
        t, prep[layer.name], layer.relu, dtype, "reflect"))
    xp = _qconv_apply(x, prep["dconv1_2"], True, dtype, "edge")  # upsample folded in
    xp = _qconv_apply(xp, prep["dconv1_1"], False, dtype, "edge")
    return unpack_d2s(xp, 3)


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


def _encode(prep: Dict, images: torch.Tensor, dtype: torch.dtype, fused: bool,
            qconv=qconv3x3_s8) -> torch.Tensor:
    """The int8-static encoder; ``qconv`` runs each K0 conv of the unfused
    path (``parallel/spatial.py`` wraps it in a halo exchange)."""
    x = vgg.conv1x1(images.to(dtype), prep["conv0"])  # 1x1 RGB rescale, no relu
    xq = pack_s2d(quantize_static(x, prep["__scales__"]["conv1_1"] / 127.0))
    if fused:
        xq = encoder_level1(xq, prep["conv1_1"], prep["conv1_2"], prep["__level1__"])
    else:
        xq = qconv(xq, prep["conv1_1"], True, dtype, "edge")
        xq = qconv(xq, prep["conv1_2"], True, dtype, "edge")
        xq = phase_max(xq, 64)  # int8 max == max on the shared scale
    # conv4_1 dequantizes: relu4_1 features in dtype
    return _walk(_ENC_TAIL, xq, lambda t, layer: qconv(
        t, prep[layer.name], layer.relu, dtype, "reflect"))


def _decode(prep: Dict, feat: torch.Tensor, dtype: torch.dtype, fused: bool,
            qconv=qconv3x3_s8) -> torch.Tensor:
    """The int8-static decoder; ``qconv`` as for :func:`_encode`."""
    xq = quantize_static(feat, prep["__scales__"]["dconv4_1"] / 127.0)
    xq = _walk(_DEC_MID, xq, lambda t, layer: qconv(
        t, prep[layer.name], layer.relu, dtype, "reflect"))
    if fused:
        y = decoder_level1(xq, prep["dconv1_2"], prep["dconv1_1"], dtype, prep["__level1__"])
    else:
        xq = qconv(xq, prep["dconv1_2"], True, dtype, "edge")
        y = qconv(xq, prep["dconv1_1"], False, dtype, "edge")
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
    with no_tf32():
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
