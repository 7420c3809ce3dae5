"""Reflect-pad 3x3 conv + bias + ReLU: CUDA kernel wrapper and plain version.

Replaces ``ccst_tpu/kernels/conv_pallas.py::reflect_conv3x3_fused`` (K3), the
conv of every 3x3 layer in the VGG encoder and decoder. The kernel is
``csrc/reflect_conv3x3.cu`` (an implicit GEMM on bf16 tensor cores, built by
``kernels/_build.py``); its header says what bounds it on the H100 and how the
design answers that.

Weights are prepared once per layer (:func:`prepare_conv`): the HWIO tensor for
the plain version, and the kernel's GEMM layout, a ``(Kp, Np)`` row-major
matrix whose rows are HWIO's ``(dy, dx, ci)`` and whose padding is zero.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

# Tile sizes of csrc/reflect_conv3x3.cu (BK, BN); the packed weights are padded
# to them so the kernel reads the weight tile without bounds checks.
TILE_K = 32
TILE_N = 64


class ConvWeights(NamedTuple):
    """One conv layer, prepared for the compute dtype and device."""

    w: torch.Tensor                 # (kh, kw, Cin, Cout) HWIO, compute dtype
    b: torch.Tensor                 # (Cout,) float32, rounded through the dtype
    packed: Optional[torch.Tensor]  # 3x3 only: (Kp, Np) kernel layout


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def pack_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> the kernel's zero-padded (Kp, Np) matrix."""
    kh, kw, cin, cout = w_hwio.shape
    k = kh * kw * cin
    out = w_hwio.new_zeros((_round_up(k, TILE_K), _round_up(cout, TILE_N)))
    out[:k, :cout] = w_hwio.reshape(k, cout)
    return out


def _tensor(a) -> torch.Tensor:
    # numpy views of JAX arrays are read-only; torch wants its own copy
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def prepare_conv(w_hwio, b, dtype: torch.dtype, device) -> ConvWeights:
    """Cast once to ``dtype`` on ``device``. The bias is rounded through
    ``dtype`` and kept in float32, as the JAX engine casts every weight to the
    compute dtype and its conv adds the bias in float32."""
    w = _tensor(w_hwio).to(device=device, dtype=dtype).contiguous()
    b = _tensor(b).to(device=device, dtype=dtype).float().contiguous()
    packed = pack_weight(w).contiguous() if w.shape[0] == 3 else None
    return ConvWeights(w=w, b=b, packed=packed)


def reflect_conv3x3_reference(
    x: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """Plain version: torch ReflectionPad2d(1) + 3x3 conv on the operands
    upcast to float32, + float32 bias, optional ReLU, one rounding to x.dtype."""
    xf = x.float().permute(0, 3, 1, 2)
    xf = F.pad(xf, (1, 1, 1, 1), mode="reflect")
    wf = w_hwio.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = F.conv2d(xf, wf) + b.float().view(1, -1, 1, 1)
    if relu:
        out = torch.relu(out)
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def reflect_conv3x3(x: torch.Tensor, cw: ConvWeights, relu: bool = True) -> torch.Tensor:
    """(N, H, W, Cin) -> (N, H, W, Cout) in x.dtype; the CUDA kernel on a CUDA
    tensor (bf16 only), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return reflect_conv3x3_reference(x, cw.w, cw.b, relu)
    n, h, w, cin = x.shape
    kh, kw, wcin, cout = cw.w.shape
    if (kh, kw, wcin) != (3, 3, cin):
        raise ValueError(f"weights {tuple(cw.w.shape)} do not fit input {tuple(x.shape)}")
    if h < 2 or w < 2:
        raise ValueError(f"reflection padding needs H, W >= 2, got {h}x{w}")
    if x.dtype != torch.bfloat16 or cw.packed.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA conv kernel takes bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the CUDA conv kernel takes a contiguous NHWC tensor")
    for t in (cw.packed, cw.b):
        if t.device != x.device:
            raise ValueError("weights and input are on different devices")
    if x.data_ptr() % 16 or cw.packed.data_ptr() % 16:
        raise ValueError("the CUDA conv kernel needs 16-byte aligned operands")
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    kp, np_ = cw.packed.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ccst_reflect_conv3x3_bf16(
            x.data_ptr(), cw.packed.data_ptr(), cw.b.data_ptr(), y.data_ptr(),
            n, h, w, cin, cout, kp, np_, int(relu), stream,
        )
    if rc:
        raise RuntimeError(f"reflect_conv3x3 launch failed: CUDA error {rc}")
    reflect_conv3x3.launches += 1
    return y


reflect_conv3x3.launches = 0
