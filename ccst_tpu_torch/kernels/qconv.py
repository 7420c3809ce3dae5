"""int8 3x3 conv with the static-scale epilogue: CUDA kernel wrapper and plain
version.

Replaces ``ccst_tpu/models/vgg_fast.py::_qconv_s`` (K0), which XLA emitted on
the TPU: pad the int8 input (edge or reflect), 3x3 conv with int32
accumulation, then per output channel ``y = float(acc) * k + kb`` and either

  - requant: ``rint`` (half to even), clip to ``[0 if relu else -127, 127]``,
    int8 (the next layer's input, already on its scale); or
  - dequant: optional ReLU, then the output dtype (bf16 on the engines' path).

The kernel is ``csrc/qconv3x3_s8.cu`` (an implicit GEMM on int8 ``wgmma``,
built by ``kernels/_build.py``); its header says what bounds it on the H100 and
how the design answers that. It takes the weights in its own layout, made once
by :func:`make_qconv` (:func:`pack_weight`): for Cin a multiple of 16 the stage
tiles of ``kernels/igemm_layout.py``, which the kernel fetches whole; otherwise
(the packed conv1_1, Cin = 12) the ``(Np, Kp)`` output-channel-major matrix of
:func:`gemm_weight` for the kernel's 4-byte gather route. The fused kernels
(K1, K2, B3) pack their own stage tiles from ``wq``.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ccst_tpu_torch.kernels.igemm_layout import pack_stage_tiles, pick_bn

# csrc/qconv3x3_s8.cu: the narrow output-channel tile of its wgmma path, and
# the tile (BK, BN) that gemm_weight pads the weight matrix to.
NARROW_N = 16
TILE_K = 64
TILE_N = 64

_OUT_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


class QConvS(NamedTuple):
    """One int8-static conv layer (``ccst_tpu`` ``vgg_fast.QConvS``), on a device."""

    wq: torch.Tensor   # (3, 3, Cin, Cout) int8 HWIO (packed layers: the packed kernel)
    k: torch.Tensor    # (Cout,) f32 per-output-channel multiplier
    kb: torch.Tensor   # (Cout,) f32 per-output-channel additive term
    packed: bool
    requant: bool      # True -> int8 output; False -> dequantized output
    wp: torch.Tensor   # int8: this kernel's weight layout (pack_weight)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def gemm_weight(wq: np.ndarray) -> np.ndarray:
    """HWIO (3, 3, Cin, Cout) int8 -> the kernels' zero-padded (Np, Kp) matrix,
    row n holding output channel n's weights in (dy, dx, ci) order."""
    kh, kw, cin, cout = wq.shape
    k = kh * kw * cin
    out = np.zeros((_round_up(cout, TILE_N), _round_up(k, TILE_K)), np.int8)
    out[:cout, :k] = np.asarray(wq).reshape(k, cout).T
    return out


def uses_wgmma(cin: int) -> bool:
    """The kernel's path is picked by Cin alone: 16-byte channel groups."""
    return cin % 16 == 0


def pack_weight(wq: np.ndarray) -> np.ndarray:
    """HWIO (3, 3, Cin, Cout) int8 -> the weights of ``csrc/qconv3x3_s8.cu``:
    stage tiles (n tiles, chunks, 9, 8, BN, 16) when Cin % 16 == 0, else the
    (Np, Kp) matrix of the gather path."""
    wq = np.ascontiguousarray(wq, np.int8)
    if uses_wgmma(wq.shape[2]):
        return pack_stage_tiles(torch.from_numpy(wq), pick_bn(wq.shape[3], NARROW_N)).numpy()
    return gemm_weight(wq)


def make_qconv(wq, k, kb, packed: bool, requant: bool, device) -> QConvS:
    """A :class:`QConvS` on ``device`` from numpy int8 weights and f32 scales."""
    wq = np.asarray(wq, np.int8)

    def dev(a):  # a copy: numpy views of JAX arrays are read-only
        return torch.from_numpy(np.array(a)).to(device)

    return QConvS(
        wq=dev(wq), k=dev(np.asarray(k, np.float32)), kb=dev(np.asarray(kb, np.float32)),
        packed=packed, requant=requant, wp=dev(pack_weight(wq)),
    )


def qconv3x3_s8_reference(
    x: torch.Tensor, wq: torch.Tensor, k: torch.Tensor, kb: torch.Tensor, relu: bool,
    requant: bool, out_dtype: torch.dtype, pad_mode: str,
) -> torch.Tensor:
    """Plain version. The conv runs in float64 on the padded int8 values: every
    product and partial sum is an integer below 2**53 (|acc| <= 127**2 * 9 *
    512 ~ 7.4e7), so it is exact and equals the int32 accumulation. Rounding it
    to float32 rounds the same integer as int32 -> float32 does. The epilogue
    is two separate float32 ops, as XLA runs them."""
    mode = {"edge": "replicate", "reflect": "reflect"}[pad_mode]
    xd = F.pad(x.permute(0, 3, 1, 2).double(), (1, 1, 1, 1), mode=mode)
    acc = F.conv2d(xd, wq.double().permute(3, 2, 0, 1))
    y = acc.permute(0, 2, 3, 1).float()
    y = y * k
    y = y + kb
    if not requant:
        if relu:
            y = torch.clamp_min(y, 0.0)
        return y.to(out_dtype).contiguous()
    lo = 0.0 if relu else -127.0
    return torch.clamp(torch.round(y), lo, 127.0).to(torch.int8).contiguous()


def _check_operands(x: torch.Tensor, *weights: torch.Tensor) -> None:
    if x.dtype != torch.int8:
        raise TypeError(f"the int8 conv kernels take int8 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the int8 conv kernels take a contiguous NHWC tensor")
    for t in weights:
        if t.device != x.device:
            raise ValueError("weights and input are on different devices")
        if not t.is_contiguous():
            raise ValueError("the int8 conv kernels take contiguous weights")
    if x.data_ptr() % 16 or any(t.data_ptr() % 16 for t in weights):
        raise ValueError("the int8 conv kernels need 16-byte aligned operands")


def launch_qconv(x: torch.Tensor, q: QConvS, relu: bool, out: torch.dtype, pad_mode: str,
                 row_shift: int = 0) -> torch.Tensor:
    """Launch K0 on a CUDA tensor after the checks its kernel needs; the
    caller counts the launch. ``row_shift``: output row h is the conv centred
    on input row h - row_shift (the wgmma route only: Cin % 16 == 0)."""
    n, h, w, cin = x.shape
    kh, kw, wcin, cout = q.wq.shape
    if (kh, kw, wcin) != (3, 3, cin):
        raise ValueError(f"weights {tuple(q.wq.shape)} do not fit input {tuple(x.shape)}")
    if cin % 4:
        raise ValueError(f"the int8 conv kernel needs Cin % 4 == 0, got {cin}")
    if row_shift and not uses_wgmma(cin):
        raise ValueError(f"a row shift needs Cin % 16 == 0, got {cin}")
    if pad_mode == "reflect" and (h < 2 or w < 2):
        raise ValueError(f"reflection padding needs H, W >= 2, got {h}x{w}")
    if out not in _OUT_KIND:
        raise TypeError(f"the int8 conv kernel writes int8, bfloat16 or float32, not {out}")
    _check_operands(x, q.wp, q.k, q.kb)
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    y = torch.empty((n, h, w, cout), dtype=out, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ccst_qconv3x3_s8(
            x.data_ptr(), q.wp.data_ptr(), q.k.data_ptr(), q.kb.data_ptr(), y.data_ptr(),
            n, h, w, cin, cout, int(pad_mode == "reflect"), int(relu),
            _OUT_KIND[out], row_shift, stream,
        )
    if rc:
        raise RuntimeError(f"qconv3x3_s8 launch failed: CUDA error {rc}")
    return y


def qconv3x3_s8(
    x: torch.Tensor, q: QConvS, relu: bool, out_dtype: torch.dtype, pad_mode: str
) -> torch.Tensor:
    """(N, H, W, Cin) int8 -> (N, H, W, Cout): int8 when ``q.requant``, else
    ``out_dtype``. The CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor. ``pad_mode`` is ``"edge"`` or ``"reflect"``."""
    if pad_mode not in ("edge", "reflect"):
        raise ValueError(f"pad_mode must be 'edge' or 'reflect', got {pad_mode!r}")
    if x.device.type == "cpu":
        return qconv3x3_s8_reference(x, q.wq, q.k, q.kb, relu, q.requant, out_dtype, pad_mode)
    y = launch_qconv(x, q, relu, torch.int8 if q.requant else out_dtype, pad_mode)
    qconv3x3_s8.launches += 1
    return y


qconv3x3_s8.launches = 0
