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
``csrc/pool_conv_s8.cu``; its header says what bounds it on the H100 (bytes)
and what the design does about it: K0's conv2_1 on the ``wgmma`` core
(``csrc/conv_igemm_sm90.cuh``) with a pooling producer that builds the pooled
halo of a tile in the core's shared-memory planes, and weight stages that are
dense in K (:func:`prepare_pool_conv`). ``cat`` selects its reduction step as
the reference's does: 9 steps of K = 64 (F9) or 3 steps of K = 192 (F3). Unlike
the reference there is no row-tile rule: any Hb, Wb >= 2 runs.

:func:`simulate_pool_conv` walks the kernel's tiles, pooled halo planes, weight
stages and accumulator columns in numpy: the executable description of its
addressing, which the CPU tests hold against the plain version since the
kernel runs only on the card.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ccst_tpu_torch.kernels import igemm_layout as il
from ccst_tpu_torch.kernels.level1 import phase_max
from ccst_tpu_torch.kernels.qconv import NARROW_N, QConvS, _check_operands, qconv3x3_s8_reference

GROUP = 64                 # pooled channels: one lane group of the packed input
K_GROUPS = GROUP // 16     # 16-byte groups of a pooled pixel: the core's 64-byte mode


def pool_conv_reference(xp: torch.Tensor, q: QConvS) -> torch.Tensor:
    """Plain version: the phase max, then K0's plain reflect conv (requant,
    ReLU)."""
    return qconv3x3_s8_reference(phase_max(xp, GROUP), q.wq, q.k, q.kb, True, True,
                                 torch.int8, "reflect")


def prepare_pool_conv(q: QConvS) -> torch.Tensor:
    """The (3, 3, 64, Cout) kernel as the 64-byte stage tiles of
    ``csrc/pool_conv_s8.cu``, (n tiles, 1, 9, 4, BN, 16) int8 on ``q``'s device:
    K0's output-channel tile for this Cout, a tap's weights BN x 64 bytes, the
    taps of a tile one run (a stage is one of them, three, or all nine)."""
    return il.pack_stage_tiles(q.wq, il.pick_bn(q.wq.shape[3], NARROW_N), K_GROUPS)


def simulate_pool_conv(xp: np.ndarray, q: QConvS, packed: torch.Tensor, cat: bool) -> np.ndarray:
    """What B3 computes, (N, Hb, Wb, Cout) int8, walked as the kernel walks it:
    per 8 x 16 tile the 10 x 18 halo of the POOLED plane by reflect index, each
    pixel the max over the four 64-byte phase groups, as planes ``[group][halo
    slot][16]``; then per stage of ``packed`` (one tap, or the three column taps
    of a kernel row with ``cat``; all nine for the narrow tile) each tap a
    start slot into the planes; requant + ReLU of the accumulator columns."""
    n_img, hb, wb, _ = xp.shape
    cout = q.wq.shape[3]
    w = packed.numpy().astype(np.int64)
    tiles, _, taps, groups, bn, _ = w.shape
    tps = 9 if bn == NARROW_N else (3 if cat else 1)
    stages = w[:, 0].reshape(tiles, taps // tps, tps, groups, bn, 16)
    k, kb = np.zeros(tiles * bn, np.float32), np.zeros(tiles * bn, np.float32)
    k[:cout], kb[:cout] = q.k.numpy(), q.kb.numpy()
    xp = xp.astype(np.int64)
    out = np.zeros((n_img, hb, wb, tiles * bn), np.int8)
    r = np.arange(64)
    p = np.arange(il.HALO_PX)
    for n in range(n_img):
        for y0 in range(0, hb, il.TILE_H):
            for x0 in range(0, wb, il.TILE_W):
                gy = il.pad_index(y0 - 1 + p // il.HALO_W, hb, True)
                gx = il.pad_index(x0 - 1 + p % il.HALO_W, wb, True)
                pooled = xp[n, gy, gx].reshape(il.HALO_PX, 4, groups, 16).max(axis=1)
                planes = np.zeros((groups, il.PLANE_SLOTS, 16), np.int64)
                planes[:, :il.HALO_PX] = pooled.transpose(1, 0, 2)
                for t in range(tiles):
                    for wg in range(2):
                        acc = np.zeros((64, bn), np.int64)
                        for step in range(taps // tps):
                            for tt in range(tps):
                                dy, dx = divmod(step * tps + tt, 3)
                                slots = dy * il.HALO_W + dx + 8 * wg + (r // 8) * il.HALO_W + r % 8
                                acc += np.einsum("grk,gnk->rn", planes[:, slots], stages[t, step, tt])
                        col = t * bn + np.arange(bn)
                        oy, ox = y0 + r // 8, x0 + 8 * wg + r % 8
                        ok = (oy < hb) & (ox < wb)
                        out[n, oy[ok], ox[ok], t * bn:(t + 1) * bn] = il.requant_relu(acc, k[col], kb[col])[ok]
    return out[..., :cout]


def pool_conv_fused(xp: torch.Tensor, q: QConvS, cat: bool = False,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, Hb, Wb, 256) int8 -> (N, Hb, Wb, Cout) int8. ``q``: a requantizing
    (3, 3, 64, Cout) conv (:func:`ccst_tpu_torch.kernels.qconv.make_qconv`);
    ``weights``: its :func:`prepare_pool_conv`, made here when a caller has not
    kept it. The CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
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
    wp = weights if weights is not None else prepare_pool_conv(q)
    _check_operands(xp, wp, q.k, q.kb)
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    y = torch.empty((n, hb, wb, cout), dtype=torch.int8, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream(xp.device).cuda_stream
        rc = lib.ccst_pool_conv_s8(xp.data_ptr(), wp.data_ptr(), q.k.data_ptr(),
                                   q.kb.data_ptr(), y.data_ptr(), n, hb, wb, cout,
                                   int(cat), stream)
    if rc:
        raise RuntimeError(f"pool_conv_fused launch failed: CUDA error {rc}")
    pool_conv_fused.launches += 1
    return y


pool_conv_fused.launches = 0
