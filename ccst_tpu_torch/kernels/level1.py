"""The fused level-1 stage of the int8 engines: CUDA kernel wrapper and plain
version.

Replaces ``ccst_tpu/kernels/level1_pallas.py::fused_two_conv`` in its two uses,
two chained edge-padded int8 3x3 convs with the intermediate kept on chip:

  - :func:`encoder_level1` (K1): packed int8 (N, H/2, W/2, 12) -> conv1_1
    (requant + ReLU) -> conv1_2 (requant + ReLU) -> max over the 4 phases
    (pool1) -> int8 (N, H/2, W/2, 64);
  - :func:`decoder_level1` (K2): int8 (N, H/2, W/2, 64) -> upsample-folded
    dconv1_2 (requant + ReLU) -> packed dconv1_1 (dequant, no ReLU) -> packed
    image (N, H/2, W/2, 12) in the output dtype.

The kernel is ``csrc/level1_s8.cu``; its header says what bounds it on the H100
and how the design answers that. Its plain version is the unfused chain of two
K0 plain versions (``kernels/qconv.py``) and, for K1, ``phase_max``: the
reference the JAX package holds its Pallas kernel to. Unlike the Pallas kernel
there is no row-tile rule: any image size runs.

On a CPU tensor the wrappers compute the plain version; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

import torch

from ccst_tpu_torch.kernels.qconv import QConvS, _check_operands, qconv3x3_s8_reference

CMID = 256


def phase_max(xp: torch.Tensor, c: int) -> torch.Tensor:
    """2x2/2 max pool of the original plane == max over the 4 phases of the
    packed tensor (``ccst_tpu`` ``vgg_fast.phase_max``)."""
    n, hb, wb, _ = xp.shape
    return xp.reshape(n, hb, wb, 4, c).amax(dim=3)


def encoder_level1_reference(x: torch.Tensor, q1: QConvS, q2: QConvS) -> torch.Tensor:
    """Plain K1: the unfused K0 chain, then the phase max."""
    y = qconv3x3_s8_reference(x, q1.wq, q1.k, q1.kb, True, True, torch.int8, "edge")
    y = qconv3x3_s8_reference(y, q2.wq, q2.k, q2.kb, True, True, torch.int8, "edge")
    return phase_max(y, q2.wq.shape[3] // 4).contiguous()


def decoder_level1_reference(
    y: torch.Tensor, q2: QConvS, q1: QConvS, out_dtype: torch.dtype
) -> torch.Tensor:
    """Plain K2: folded dconv1_2 (requant + ReLU), then dconv1_1 (dequant)."""
    z = qconv3x3_s8_reference(y, q2.wq, q2.k, q2.kb, True, True, torch.int8, "edge")
    return qconv3x3_s8_reference(z, q1.wq, q1.k, q1.kb, False, False, out_dtype, "edge")


def _launch(x: torch.Tensor, q1: QConvS, q2: QConvS, pool: bool, out: torch.Tensor) -> None:
    n, hb, wb, cin = x.shape
    _check_operands(x, q1.wt, q1.k, q1.kb, q2.wt, q2.k, q2.kb)
    if out.data_ptr() % 16:
        raise ValueError("the fused level-1 kernel needs a 16-byte aligned output")
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    cout = q2.wq.shape[3]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ccst_fused_two_conv_s8(
            x.data_ptr(), q1.wt.data_ptr(), q1.k.data_ptr(), q1.kb.data_ptr(),
            q2.wt.data_ptr(), q2.k.data_ptr(), q2.kb.data_ptr(), out.data_ptr(),
            n, hb, wb, cin, q1.wt.shape[1], q2.wt.shape[1], cout, int(pool), stream,
        )
    if rc:
        raise RuntimeError(f"fused level-1 kernel launch failed: CUDA error {rc}")


def encoder_level1(xq_packed: torch.Tensor, q1: QConvS, q2: QConvS) -> torch.Tensor:
    """Packed quantized input (N, H/2, W/2, 12) int8 -> pool1 (N, H/2, W/2, 64)
    int8. q1/q2: the packed conv1_1 / conv1_2."""
    if xq_packed.device.type == "cpu":
        return encoder_level1_reference(xq_packed, q1, q2)
    n, hb, wb, cin = xq_packed.shape
    if (tuple(q1.wq.shape) != (3, 3, 12, CMID) or tuple(q2.wq.shape) != (3, 3, CMID, CMID)
            or cin != 12 or not (q1.requant and q2.requant)):
        raise ValueError(
            f"encoder_level1 takes (N, H, W, 12) int8 and requantizing 12->{CMID}->{CMID} "
            f"packed weights, got {tuple(xq_packed.shape)}, {tuple(q1.wq.shape)}, "
            f"{tuple(q2.wq.shape)}"
        )
    out = torch.empty((n, hb, wb, CMID // 4), dtype=torch.int8, device=xq_packed.device)
    _launch(xq_packed, q1, q2, True, out)
    encoder_level1.launches += 1
    return out


def decoder_level1(
    yq: torch.Tensor, q2: QConvS, q1: QConvS, out_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """dconv2_1 output (N, H/2, W/2, 64) int8 -> packed image (N, H/2, W/2, 12)
    in ``out_dtype``. q2/q1: the folded dconv1_2 / packed dconv1_1."""
    if yq.device.type == "cpu":
        return decoder_level1_reference(yq, q2, q1, out_dtype)
    n, hb, wb, cin = yq.shape
    cout = q1.wq.shape[3]
    if (tuple(q2.wq.shape) != (3, 3, 64, CMID) or tuple(q1.wq.shape[:3]) != (3, 3, CMID)
            or cin != 64 or cout > 16 or cout % 2 or not q2.requant or q1.requant):
        raise ValueError(
            f"decoder_level1 takes (N, H, W, 64) int8, requantizing 64->{CMID} and "
            f"dequantizing {CMID}->Cout (Cout even, <= 16) weights, got "
            f"{tuple(yq.shape)}, {tuple(q2.wq.shape)}, {tuple(q1.wq.shape)}"
        )
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the fused level-1 kernel writes bfloat16, not {out_dtype}")
    out = torch.empty((n, hb, wb, cout), dtype=out_dtype, device=yq.device)
    _launch(yq, q2, q1, False, out)
    decoder_level1.launches += 1
    return out


encoder_level1.launches = 0
decoder_level1.launches = 0
