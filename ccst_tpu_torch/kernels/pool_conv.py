"""pool1 fused into conv2_1 (phase max, then a reflect-padded int8 3x3 conv
with the requant + ReLU epilogue): CUDA kernel wrapper and plain version (B3).

Replaces ``benchmarks/fused_pool_conv_ab.py::pool_conv_fused``, the JAX
project's A/B of computing conv2_1 straight from conv1_2's packed output. The
input is the packed conv1_2 output ``xp`` (N, Hb, Wb, 256) int8, whose four
64-channel groups are the 2x2 phases of the original plane; the output is
conv2_1's int8 output (N, Hb, Wb, Cout).

The plain version is the unfused production chain, :func:`phase_max` and then
K0's plain version with reflect padding: exactly the reference's
``production()``, which its kernel is held to bit for bit. The kernel is
``csrc/pool_conv_s8.cu``; its header says what bounds it on the H100. ``cat``
selects its reduction step as the reference's does: 9 steps of K = 64 (F9) or 3
steps of K = 192 (F3). Unlike the reference there is no row-tile rule: any
Hb, Wb >= 2 runs.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ccst_tpu_torch.kernels.level1 import phase_max
from ccst_tpu_torch.kernels.qconv import QConvS, _check_operands, qconv3x3_s8_reference

GROUP = 64  # pooled channels: one lane group of the packed input


def pool_conv_reference(xp: torch.Tensor, q: QConvS) -> torch.Tensor:
    """Plain version: the phase max, then K0's plain reflect conv (requant,
    ReLU)."""
    return qconv3x3_s8_reference(phase_max(xp, GROUP), q.wq, q.k, q.kb, True, True,
                                 torch.int8, "reflect")


def pool_conv_fused(xp: torch.Tensor, q: QConvS, cat: bool = False) -> torch.Tensor:
    """(N, Hb, Wb, 256) int8 -> (N, Hb, Wb, Cout) int8. ``q``: a requantizing
    (3, 3, 64, Cout) conv (:func:`ccst_tpu_torch.kernels.qconv.make_qconv`).
    The CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    n, hb, wb, c = xp.shape
    cout = q.wq.shape[3]
    if c != 4 * GROUP or tuple(q.wq.shape[:3]) != (3, 3, GROUP) or not q.requant:
        raise ValueError(f"pool_conv_fused takes (N, Hb, Wb, {4 * GROUP}) int8 and a "
                         f"requantizing (3, 3, {GROUP}, Cout) conv, got {tuple(xp.shape)}, "
                         f"{tuple(q.wq.shape)}")
    if xp.device.type == "cpu":
        return pool_conv_reference(xp, q)
    if hb < 2 or wb < 2 or cout % 2:
        raise ValueError(f"the fused pool+conv kernel needs Hb, Wb >= 2 and an even Cout, "
                         f"got {hb}x{wb}, Cout {cout}")
    _check_operands(xp, q.wt, q.k, q.kb)
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    y = torch.empty((n, hb, wb, cout), dtype=torch.int8, device=xp.device)
    np_, kp = q.wt.shape
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        rc = lib.ccst_pool_conv_s8(xp.data_ptr(), q.wt.data_ptr(), q.k.data_ptr(),
                                   q.kb.data_ptr(), y.data_ptr(), n, hb, wb, cout, kp, np_,
                                   int(cat), stream)
    if rc:
        raise RuntimeError(f"pool_conv_fused launch failed: CUDA error {rc}")
    pool_conv_fused.launches += 1
    return y


pool_conv_fused.launches = 0
