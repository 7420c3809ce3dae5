"""VGG-19 (normalised) encoder through relu4_1 and its mirror decoder, NHWC.

Port of ``ccst_tpu/models/vgg.py`` (reference style_transfer/AdaIN/net.py:6-92).
The architecture is the same declarative spec, interpreted by one apply loop:

  - every 3x3 conv (reflection pad 1, bias, optional ReLU) runs through
    ``kernels/conv.py``: the CUDA kernel on the card, its plain version on CPU;
  - the 1x1 ``conv0`` (3 -> 3, no pad), the ceil-mode 2x2 max pools and the
    nearest 2x upsamples are plain torch, as the JAX package leaves them to XLA.

Activations are in the compute dtype; convs accumulate in float32 and round
once, like ``ccst_tpu.models.vgg.conv2d``.

Parameters come in two forms: ``Params``, a dict ``{name: {"w": HWIO, "b"}}``
as the JAX package and the ``.npz`` format hold them, and ``Prepared``, made
once by :func:`prepare_params` for a dtype and device, which the apply
functions take.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ccst_tpu_torch.kernels.conv import ConvWeights, prepare_conv, reflect_conv3x3

Params = Dict[str, Dict[str, torch.Tensor]]
Prepared = Dict[str, ConvWeights]


class Conv(NamedTuple):
    name: str
    cin: int
    cout: int
    ksize: int = 3          # 3 => reflection-pad 1 then VALID; 1 => no pad
    relu: bool = True


class Pool(NamedTuple):     # ceil-mode 2x2 stride-2 max pool
    pass


class Upsample(NamedTuple): # nearest-neighbor 2x
    pass


class Tap(NamedTuple):      # marks a named intermediate output (after prev layer)
    name: str


# vgg_normalised through relu4_1 (net.py:38-69; children [:31]).
ENCODER_ARCH: Tuple = (
    Conv("conv0", 3, 3, ksize=1, relu=False),   # RGB rescale layer
    Conv("conv1_1", 3, 64), Tap("relu1_1"),
    Conv("conv1_2", 64, 64),
    Pool(),
    Conv("conv2_1", 64, 128), Tap("relu2_1"),
    Conv("conv2_2", 128, 128),
    Pool(),
    Conv("conv3_1", 128, 256), Tap("relu3_1"),
    Conv("conv3_2", 256, 256),
    Conv("conv3_3", 256, 256),
    Conv("conv3_4", 256, 256),
    Pool(),
    Conv("conv4_1", 256, 512), Tap("relu4_1"),
)

# Mirror decoder (net.py:6-36); final conv has no activation.
DECODER_ARCH: Tuple = (
    Conv("dconv4_1", 512, 256),
    Upsample(),
    Conv("dconv3_4", 256, 256),
    Conv("dconv3_3", 256, 256),
    Conv("dconv3_2", 256, 256),
    Conv("dconv3_1", 256, 128),
    Upsample(),
    Conv("dconv2_2", 128, 128),
    Conv("dconv2_1", 128, 64),
    Upsample(),
    Conv("dconv1_2", 64, 64),
    Conv("dconv1_1", 64, 3, relu=False),
)


def reflect_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """torch ReflectionPad2d on an NHWC tensor."""
    y = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (pad,) * 4, mode="reflect")
    return y.permute(0, 2, 3, 1).contiguous()


def conv1x1(x: torch.Tensor, cw: ConvWeights) -> torch.Tensor:
    """1x1 conv, float32 accumulation + bias, rounded to x.dtype."""
    cin, cout = cw.w.shape[2], cw.w.shape[3]
    out = x.float() @ cw.w.float().reshape(cin, cout) + cw.b
    return out.to(x.dtype)


def maxpool_ceil(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool with ceil_mode=True. Odd sizes are padded with the
    identity of max: -inf for floats, the type's minimum for integers (the
    int8 engines pool quantized tensors)."""
    n, h, w, c = x.shape
    pad_h, pad_w = h % 2, w % 2
    if pad_h or pad_w:
        if x.dtype.is_floating_point:
            fill = float("-inf")
        else:
            fill = torch.iinfo(x.dtype).min
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h), value=fill)
        h, w = h + pad_h, w + pad_w
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, h * 2, w * 2, c)


def init_params(arch: Sequence, generator: torch.Generator) -> Params:
    """Kaiming-uniform init (torch Conv2d default), float32 on the CPU.

    Same bounds as the JAX ``init_params``; the numbers differ, as torch and
    JAX draw differently from a seed."""
    params: Params = {}
    for layer in arch:
        if not isinstance(layer, Conv):
            continue
        fan_in = layer.cin * layer.ksize * layer.ksize
        bound = math.sqrt(1.0 / fan_in)
        shape = (layer.ksize, layer.ksize, layer.cin, layer.cout)
        w = (torch.rand(shape, generator=generator) * 2 - 1) * bound
        b = (torch.rand((layer.cout,), generator=generator) * 2 - 1) * bound
        params[layer.name] = {"w": w, "b": b}
    return params


def prepare_params(params, dtype: torch.dtype, device) -> Prepared:
    """Cast every layer once to ``dtype`` on ``device``, with the conv
    kernel's weight layout for the 3x3 layers. Values may be tensors or numpy
    arrays."""
    return {
        name: prepare_conv(p["w"], p["b"], dtype, device) for name, p in params.items()
    }


def _apply(params: Prepared, x: torch.Tensor, arch: Sequence, stop_at: str = ""):
    for layer in arch:
        if isinstance(layer, Conv):
            cw = params[layer.name]
            if layer.ksize == 3:
                x = reflect_conv3x3(x, cw, relu=layer.relu)
            else:
                x = conv1x1(x, cw)
                if layer.relu:
                    x = torch.relu(x)
        elif isinstance(layer, Pool):
            x = maxpool_ceil(x)
        elif isinstance(layer, Upsample):
            x = upsample_nearest2x(x)
        elif isinstance(layer, Tap):
            if layer.name == stop_at:
                return x
        else:
            raise TypeError(f"unknown layer spec {layer!r}")
    return x


def apply_encoder(params: Prepared, images: torch.Tensor) -> torch.Tensor:
    """Images (N, H, W, 3) in [0, 1] -> relu4_1 features (N, H/8, W/8, 512)."""
    return _apply(params, images, ENCODER_ARCH, stop_at="relu4_1")


def apply_decoder(params: Prepared, feat: torch.Tensor) -> torch.Tensor:
    """relu4_1 features -> image (N, H*8, W*8, 3); raw output, no activation."""
    return _apply(params, feat, DECODER_ARCH)
