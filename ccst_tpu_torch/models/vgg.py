"""VGG-19 (normalised) encoder through relu4_1 and its mirror decoder, NHWC;
for WCT, the encoder on to relu5_1 and a mirror decoder for each of its five
levels.

Port of ``ccst_tpu/models/vgg.py`` (reference style_transfer/AdaIN/net.py:6-92).
The architecture is the same declarative spec, interpreted by one apply loop
along one of two routes, chosen by the caller's ``route`` argument:

  - ``"kernel"`` (every pass that needs no gradient): every 3x3 conv
    (reflection pad 1, bias, optional ReLU) runs through ``kernels/conv.py``,
    the CUDA kernel on the card, its plain version on CPU; the 1x1 ``conv0``
    (3 -> 3, no pad), the ceil-mode 2x2 max pools and the nearest 2x upsamples
    are plain torch, as the JAX package leaves them to XLA. Activations are in
    the compute dtype; convs accumulate in float32 and round once, like
    ``ccst_tpu.models.vgg.conv2d``.
  - ``"autograd"`` (decoder training and the inverter's perceptual loss): a
    reflect-padded ``F.conv2d`` under autograd, in the parameters' dtype; the
    caller runs it inside ``utils/precision.py::no_tf32`` for float32 on the
    card. The JAX package trains through XLA's convs, not Pallas, so no TPU
    kernel has a backward to port; the CUDA kernel has none either and refuses
    a tensor that requires grad.

Parameters come in three forms: ``Params``, a dict ``{name: {"w": HWIO, "b"}}``
as the JAX package and the ``.npz`` format hold them; ``Prepared``, made once
by :func:`prepare_params` for a dtype and device, which the kernel route takes;
``Trainable``, ``{name: {"w": OIHW, "b"}}`` ``nn.Parameter``s made by
:func:`trainable_params`, which the autograd route takes and
:func:`params_from_trainable` turns back into ``Params``.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ccst_tpu_torch.kernels.conv import ConvWeights, prepare_conv, reflect_conv3x3

Params = Dict[str, Dict[str, torch.Tensor]]
Prepared = Dict[str, ConvWeights]
Trainable = Dict[str, Dict[str, torch.nn.Parameter]]
ROUTES = ("kernel", "autograd")
TAPS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1")


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


# WCT (Li et al., arXiv:1705.08086; the encoders and decoders of PytorchWCT):
# the same normalised VGG-19 on to relu5_1, tapped at each level, and one
# mirror decoder a level, coarse to fine. The relu4_1 decoder is DECODER_ARCH;
# the finer ones are its tails, the relu5_1 decoder adds conv5_1's and
# conv4_2..4_4's mirrors before it.
WCT_LEVELS = ("relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1")
WCT_ENCODER_ARCH: Tuple = ENCODER_ARCH + (
    Conv("conv4_2", 512, 512),
    Conv("conv4_3", 512, 512),
    Conv("conv4_4", 512, 512),
    Pool(),
    Conv("conv5_1", 512, 512), Tap("relu5_1"),
)


def _tail(arch: Tuple, first: str) -> Tuple:
    return arch[next(i for i, l in enumerate(arch) if getattr(l, "name", "") == first):]


WCT_DECODER_ARCHS: Dict[str, Tuple] = {
    "relu5_1": (Conv("dconv5_1", 512, 512), Upsample(), Conv("dconv4_4", 512, 512),
                Conv("dconv4_3", 512, 512), Conv("dconv4_2", 512, 512)) + DECODER_ARCH,
    "relu4_1": DECODER_ARCH,
    "relu3_1": _tail(DECODER_ARCH, "dconv3_1"),
    "relu2_1": _tail(DECODER_ARCH, "dconv2_1"),
    "relu1_1": _tail(DECODER_ARCH, "dconv1_1"),
}


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


def trainable_params(params, device, dtype: torch.dtype = torch.float32,
                     requires_grad: bool = True) -> Trainable:
    """The autograd route's parameters from a ``Params`` tree (tensors or
    numpy arrays, HWIO): OIHW weights and biases as ``nn.Parameter``s of
    ``dtype`` on ``device``; ``requires_grad=False`` for a frozen network
    through which gradients still reach the input."""
    def param(a, perm=None):
        # a copy always: the optimizer updates the parameters in place
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        t = t.detach().to(device=device, dtype=dtype, copy=True)
        return torch.nn.Parameter((t.permute(*perm) if perm else t).contiguous(),
                                  requires_grad=requires_grad)

    return {name: {"w": param(p["w"], (3, 2, 0, 1)), "b": param(p["b"])}
            for name, p in params.items()}


def params_from_trainable(trainable: Trainable) -> Params:
    """Back to the HWIO ``Params`` tree, float32 on the CPU, as
    ``models/convert.py::save_npz`` writes it (and ``ccst-tpu`` reads it)."""
    return {name: {"w": p["w"].detach().float().cpu().permute(2, 3, 1, 0).contiguous(),
                   "b": p["b"].detach().float().cpu().clone()}
            for name, p in trainable.items()}


def _reflect_pad1(y: torch.Tensor) -> torch.Tensor:
    """``F.pad(y, (1, 1, 1, 1), mode="reflect")`` of an NCHW tensor; where
    cuDNN is asked for deterministic algorithms, as slices and concatenations:
    the same values, and a backward without the atomic adds of the reflection
    pad's CUDA backward, so that a training step gives the same bits run to
    run. Elsewhere ``F.pad``, which takes less time (a 256 px ``train-decoder``
    step 93 ms against 112 ms: ``benchmarks/privacy_profile.py``)."""
    if not torch.backends.cudnn.deterministic:
        return F.pad(y, (1, 1, 1, 1), mode="reflect")
    y = torch.cat([y[:, :, 1:2], y, y[:, :, -2:-1]], dim=2)
    return torch.cat([y[:, :, :, 1:2], y, y[:, :, :, -2:-1]], dim=3)


def _conv_autograd(x: torch.Tensor, p, ksize: int, relu: bool) -> torch.Tensor:
    """NHWC conv on the autograd route: the NHWC tensor seen as NCHW in
    channels-last memory, reflect pad 1 for a 3x3 kernel, ``F.conv2d``."""
    y = x.permute(0, 3, 1, 2)
    if ksize == 3:
        y = _reflect_pad1(y)
    y = F.conv2d(y, p["w"], p["b"])
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1)


def _apply(params, x: torch.Tensor, arch: Sequence, stop_at: str = "",
           taps: Sequence[str] = (), route: str = "kernel"):
    """Walk ``arch`` from ``x``; returns the output and the named taps."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    collected = {}
    for layer in arch:
        if isinstance(layer, Conv):
            p = params[layer.name]
            if route == "autograd":
                x = _conv_autograd(x, p, layer.ksize, layer.relu)
            elif layer.ksize == 3:
                x = reflect_conv3x3(x, p, relu=layer.relu)
            else:
                x = conv1x1(x, p)
                if layer.relu:
                    x = torch.relu(x)
        elif isinstance(layer, Pool):
            x = maxpool_ceil(x)
        elif isinstance(layer, Upsample):
            x = upsample_nearest2x(x)
        elif isinstance(layer, Tap):
            if layer.name in taps:
                collected[layer.name] = x
            if layer.name == stop_at:
                return x, collected
        else:
            raise TypeError(f"unknown layer spec {layer!r}")
    return x, collected


def apply_encoder(params, images: torch.Tensor, route: str = "kernel") -> torch.Tensor:
    """Images (N, H, W, 3) in [0, 1] -> relu4_1 features (N, H/8, W/8, 512);
    ``params`` is ``Prepared`` on the kernel route, ``Trainable`` on the
    autograd route."""
    return _apply(params, images, ENCODER_ARCH, stop_at="relu4_1", route=route)[0]


def encoder_taps(params, images: torch.Tensor, route: str = "kernel") -> Dict[str, torch.Tensor]:
    """relu1_1..relu4_1 intermediate features, for the AdaIN training losses
    and the perceptual distance."""
    return _apply(params, images, ENCODER_ARCH, stop_at="relu4_1", taps=TAPS, route=route)[1]


def apply_decoder(params, feat: torch.Tensor, route: str = "kernel") -> torch.Tensor:
    """relu4_1 features -> image (N, H*8, W*8, 3); raw output, no activation."""
    return _apply(params, feat, DECODER_ARCH, route=route)[0]


def encode_to(params, images: torch.Tensor, tap: str, taps: Sequence[str] = ()):
    """WCT: images -> the features at ``tap`` (one of :data:`WCT_LEVELS`) on
    the kernel route; with ``taps``, also the named finer levels, as a dict."""
    out, collected = _apply(params, images, WCT_ENCODER_ARCH, stop_at=tap, taps=taps)
    return (out, collected) if taps else out


def decode_from(params, feat: torch.Tensor, tap: str) -> torch.Tensor:
    """WCT: features at ``tap`` -> image, through that level's decoder."""
    return _apply(params, feat, WCT_DECODER_ARCHS[tap])[0]
