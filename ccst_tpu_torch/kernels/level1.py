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

The kernels are in ``csrc/level1_s8.cu``; its header says what bounds them on
the H100 and how the design answers that. K1 is bound by operations (324 GOP
against 16 MB moved per batch of 4 at 512 px, 92% of them conv1_2's), so it
runs conv1_2 on the ``wgmma`` core of K0 (``csrc/conv_igemm_sm90.cuh``): conv1_1,
an im2col GEMM on ``wgmma`` too, writes its requantized output straight into
the core's shared-memory A planes, the core's mainloop multiplies them against
bulk-copied weight stages, and the phase max is taken in registers, which
:func:`prepare_encoder_level1` arranges by permuting conv1_2's output columns
(``igemm_layout.level1_column_order``). K2 mirrors it in one persistent block
an SM: the folded dconv1_2 runs on ``wgmma`` over flat positions of the input
tile kept as planes (a tap is a start offset, nothing is copied) against weight
stages that are dense in K (:func:`prepare_decoder_level1`) and pass once a
tile, a fix-up pass restores the edge replica on border tiles, and dconv1_1
reads the core's planes as the core does, with K0's narrow tile. The
plain version is the unfused chain of two K0 plain versions
(``kernels/qconv.py``) and, for K1, ``phase_max``: the reference the JAX
package holds its Pallas kernel to. Unlike the Pallas kernel there is no
row-tile rule: any image size runs.

:func:`simulate_encoder_level1` and :func:`simulate_decoder_level1` walk the
kernels' tiles, A rows, intermediate planes, weight stages and accumulator
registers in numpy: the executable description of their addressing, which the
CPU tests hold against the plain versions since the kernels run only on the
card.

On a CPU tensor the wrappers compute the plain version; on a CUDA tensor they
launch the kernel or raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ccst_tpu_torch.kernels import igemm_layout as il
from ccst_tpu_torch.kernels.qconv import (
    NARROW_N,
    QConvS,
    _check_operands,
    qconv3x3_s8_reference,
)

CMID = 256
E_BN = 128          # columns of one wgmma and one conv1_2 pass (csrc/level1_s8.cu)
IM2COL_ROWS = 192   # the 180 halo pixels of a tile, padded to three 64-row blocks
# K2 (csrc/level1_s8.cu, D_*): conv1 runs over flat positions of the 12 x 20
# input tile, four 64-row blocks; an input plane has 298 slots so that the
# dropped rows of the last block read inside it
D_CIN = 64
D_GROUPS = D_CIN // 16
D_BLOCKS = 4
D_IN_SLOTS = 298


class Level1Weights(NamedTuple):
    """K1's weights in its own layouts (:func:`prepare_encoder_level1`)."""

    w1p: torch.Tensor   # (2, 1, 1, 8, 128, 16) int8: conv1_1 as one stage chunk, k = (dy, dx, ci)
    w2p: torch.Tensor   # (2, 2, 9, 8, 128, 16) int8: conv1_2's stage tiles, columns permuted
    k2p: torch.Tensor   # (256,) f32: conv1_2's multiplier in the permuted column order
    kb2p: torch.Tensor  # (256,) f32: its additive term, likewise


def prepare_encoder_level1(q1: QConvS, q2: QConvS) -> Level1Weights:
    """Pack conv1_1 (3, 3, 12, 256) and conv1_2 (3, 3, 256, 256) for K1, on
    their device. conv1_1 becomes a GEMM right-hand side (K = 108 in (dy, dx,
    ci) order, zero padded to one 128-byte chunk); conv1_2 the core's stage
    tiles with its output columns in ``level1_column_order``."""
    order = torch.from_numpy(il.level1_column_order(CMID // 4, E_BN)).to(q2.wq.device)
    w1 = q1.wq.reshape(1, 1, 9 * q1.wq.shape[2], q1.wq.shape[3])
    return Level1Weights(
        w1p=il.pack_stage_tiles(w1, E_BN),
        w2p=il.pack_stage_tiles(q2.wq[..., order], E_BN),
        k2p=q2.k[order].contiguous(), kb2p=q2.kb[order].contiguous(),
    )


class DecoderLevel1Weights(NamedTuple):
    """K2's weights in its own layouts (:func:`prepare_decoder_level1`)."""

    w1p: torch.Tensor   # (2, 1, 9, 4, 128, 16) int8: the folded dconv1_2 as 64-byte stage tiles
    w2p: torch.Tensor   # (1, 2, 9, 8, 16, 16) int8: dconv1_1's stage tiles of the narrow tile (K0's)


def prepare_decoder_level1(q2: QConvS, q1: QConvS) -> DecoderLevel1Weights:
    """Pack the folded dconv1_2 (3, 3, 64, 256) and the packed dconv1_1 (3, 3,
    256, Cout <= 16) for K2, on their device. dconv1_2's stages are dense in K:
    a tap is 128 columns x 64 bytes, and the three taps of a kernel row of one
    column half are one 24 KB run, which the kernel fetches whole. dconv1_1
    is taken in K0's own layout for the narrow tile (``q1.wp``), which the
    kernel keeps in shared memory whole."""
    return DecoderLevel1Weights(w1p=il.pack_stage_tiles(q2.wq, E_BN, D_GROUPS), w2p=q1.wp)


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


def simulate_encoder_level1(x: np.ndarray, q1: QConvS, lw: Level1Weights) -> np.ndarray:
    """What K1 computes, (N, Hb, Wb, 64) int8, walked as the kernel walks it:
    per 8 x 16 tile the clamped 12 x 20 input tile; the im2col rows, row r
    gathered around halo pixel r's CLAMPED position, as planes ``[group][row
    slot][16]``; conv1_1 against ``lw.w1p``; its requantized output in the
    core's planes ``[channel // 16][halo slot][channel % 16]``; conv1_2 with
    each tap a start slot into them and the weights read from ``lw.w2p``; then
    per thread (quad lane t, pass p) the max over registers ``j = 4 jc +
    phase`` into channel ``16 t + 8 p + 2 jc + e``. ``x``: (N, Hb, Wb, 12)
    int8."""
    n_img, hb, wb, cin = x.shape
    x = x.astype(np.int64)
    w1p, w2p = lw.w1p.numpy().astype(np.int64), lw.w2p.numpy().astype(np.int64)
    k1, kb1 = q1.k.numpy(), q1.kb.numpy()
    k2p, kb2p = lw.k2p.numpy(), lw.kb2p.numpy()
    out = np.zeros((n_img, hb, wb, CMID // 4), np.int8)
    iw = il.TILE_W + 4
    r64 = np.arange(64)
    rows = np.minimum(np.arange(IM2COL_ROWS), il.HALO_PX - 1)
    words = np.arange(il.GROUPS * 4)            # 4-byte words of a row's 128 bytes of K
    tap, cword = words // 3, words % 3
    live = tap < 9
    tap_off = np.where(live, (tap // 3) * iw + tap % 3, 0)
    for n in range(n_img):
        for y0 in range(0, hb, il.TILE_H):
            for x0 in range(0, wb, il.TILE_W):
                ty = np.clip(y0 - 2 + np.arange(il.TILE_H + 4), 0, hb - 1)
                tx = np.clip(x0 - 2 + np.arange(iw), 0, wb - 1)
                tile = x[n][ty][:, tx].reshape(-1, cin)                 # (240, 12)
                hr = np.clip(y0 - 1 + rows // il.HALO_W, 0, hb - 1)
                wc = np.clip(x0 - 1 + rows % il.HALO_W, 0, wb - 1)
                centre = (hr - y0 + 1) * iw + (wc - x0 + 1)
                src = centre[:, None] + tap_off[None, :]                # (192, 32) tile pixels
                got = tile[src][np.arange(IM2COL_ROWS)[:, None, None], words[None, :, None],
                                (4 * cword[None, :, None] + np.arange(4)) % cin]
                got = np.where(live[None, :, None], got, 0)             # (192, 32, 4)
                im = np.zeros((il.GROUPS, IM2COL_ROWS + 1, 16), np.int64)
                im[:, :IM2COL_ROWS] = got.reshape(IM2COL_ROWS, il.GROUPS, 16).transpose(1, 0, 2)
                planes = np.zeros((2 * il.GROUPS, il.PLANE_SLOTS, 16), np.int64)
                for rb in range(IM2COL_ROWS // 64):
                    a = im[:, 64 * rb + r64]                            # (8, 64, 16)
                    for nh in range(2):
                        acc = np.einsum("grk,gnk->rn", a, w1p[nh, 0, 0])
                        ch = nh * E_BN + np.arange(E_BN)
                        q = il.requant_relu(acc, k1[ch], kb1[ch])
                        r = 64 * rb + r64
                        ok = r < il.HALO_PX
                        planes[ch[None, :] // 16, r[ok][:, None], ch[None, :] % 16] = q[ok]
                for wg in range(2):
                    best = np.zeros((64, CMID // 4), np.int64)
                    for p in range(2):
                        acc = np.zeros((64, E_BN), np.int64)
                        for c in range(2):
                            for t9 in range(9):
                                dy, dx = divmod(t9, 3)
                                slots = dy * il.HALO_W + dx + 8 * wg + (r64 // 8) * il.HALO_W + r64 % 8
                                a = planes[il.GROUPS * c:il.GROUPS * (c + 1)][:, slots]
                                acc += np.einsum("grk,gnk->rn", a, w2p[p, c, t9])
                        col = p * E_BN + np.arange(E_BN)
                        q = il.requant_relu(acc, k2p[col], kb2p[col])
                        for jc in range(4):
                            for t in range(4):
                                for e in range(2):
                                    regs = [il.accumulator_column(4 * jc + ph, t, e) for ph in range(4)]
                                    best[:, 16 * t + 8 * p + 2 * jc + e] = q[:, regs].max(axis=1)
                    oy, ox = y0 + r64 // 8, x0 + 8 * wg + r64 % 8
                    ok = (oy < hb) & (ox < wb)
                    out[n, oy[ok], ox[ok]] = best[ok]
    return out


def simulate_decoder_level1(x: np.ndarray, q2: QConvS, q1: QConvS,
                            dw: DecoderLevel1Weights) -> torch.Tensor:
    """What K2 computes, (N, Hb, Wb, Cout) bfloat16, walked as the kernel walks
    it: per 8 x 16 tile the clamped 12 x 20 input tile as planes ``[group][tile
    pixel, pitch 20][16]``; conv1 over flat positions ``f = 64 rb + r`` of that
    pitch, a tap the start offset ``dy * 20 + dx``, against ``dw.w1p``; the rows
    that are halo pixels (``f % 20 < 18``, ``f // 20 < 10``) requantized into
    the core's planes ``[channel // 16][halo slot][channel % 16]``; on a border
    tile the fix-up that overwrites every halo slot outside the image with the
    nearest slot inside (the edge replica); conv2 as the core's narrow tile
    with each tap a start slot and the weights read from ``dw.w2p``; the
    dequant in two float32 roundings, then bfloat16. ``x``: (N, Hb, Wb, 64)
    int8."""
    n_img, hb, wb, cin = x.shape
    cout = q1.wq.shape[3]
    x = x.astype(np.int64)
    w1p, w2p = dw.w1p.numpy().astype(np.int64), dw.w2p.numpy().astype(np.int64)
    k1, kb1 = q2.k.numpy(), q2.kb.numpy()
    k2, kb2 = q1.k.numpy().astype(np.float32), q1.kb.numpy().astype(np.float32)
    out = np.zeros((n_img, hb, wb, cout), np.float32)
    ih, iw = il.TILE_H + 4, il.TILE_W + 4
    mh = il.TILE_H + 2
    r64 = np.arange(64)
    p = np.arange(il.HALO_PX)
    for n in range(n_img):
        for y0 in range(0, hb, il.TILE_H):
            for x0 in range(0, wb, il.TILE_W):
                ty = np.clip(y0 - 2 + np.arange(ih), 0, hb - 1)
                tx = np.clip(x0 - 2 + np.arange(iw), 0, wb - 1)
                tile = x[n][ty][:, tx].reshape(ih * iw, D_GROUPS, 16)
                in_planes = np.zeros((D_GROUPS, D_IN_SLOTS, 16), np.int64)  # the slack is never kept
                in_planes[:, :ih * iw] = tile.transpose(1, 0, 2)
                planes = np.zeros((2 * il.GROUPS, il.PLANE_SLOTS, 16), np.int64)
                for rb in range(D_BLOCKS):
                    f = 64 * rb + r64
                    mr, mc = f // iw, f % iw
                    ok = (mr < mh) & (mc < il.HALO_W)
                    for nh in range(CMID // E_BN):
                        acc = np.zeros((64, E_BN), np.int64)
                        for tap in range(9):
                            dy, dx = divmod(tap, 3)
                            a = in_planes[:, f + dy * iw + dx]           # (4, 64, 16)
                            acc += np.einsum("grk,gnk->rn", a, w1p[nh, 0, tap])
                        ch = nh * E_BN + np.arange(E_BN)
                        q = il.requant_relu(acc, k1[ch], kb1[ch])
                        slot = mr[ok] * il.HALO_W + mc[ok]
                        planes[ch[None, :] // 16, slot[:, None], ch[None, :] % 16] = q[ok]
                if y0 == 0 or x0 == 0 or y0 + il.TILE_H >= hb or x0 + il.TILE_W >= wb:
                    sr = np.clip(y0 - 1 + p // il.HALO_W, 0, hb - 1) - (y0 - 1)
                    sc = np.clip(x0 - 1 + p % il.HALO_W, 0, wb - 1) - (x0 - 1)
                    planes[:, :il.HALO_PX] = planes[:, sr * il.HALO_W + sc]
                for wg in range(2):
                    acc = np.zeros((64, NARROW_N), np.int64)
                    for c in range(2):
                        for t9 in range(9):
                            dy, dx = divmod(t9, 3)
                            slots = dy * il.HALO_W + dx + 8 * wg + (r64 // 8) * il.HALO_W + r64 % 8
                            a = planes[il.GROUPS * c:il.GROUPS * (c + 1)][:, slots]
                            acc += np.einsum("grk,gnk->rn", a, w2p[0, c, t9])
                    val = acc[:, :cout].astype(np.float32) * k2
                    val = val + kb2
                    oy, ox = y0 + r64 // 8, x0 + 8 * wg + r64 % 8
                    ok = (oy < hb) & (ox < wb)
                    out[n, oy[ok], ox[ok]] = val[ok]
    return torch.from_numpy(out).to(torch.bfloat16)


def _launch(x: torch.Tensor, w1: torch.Tensor, k1: torch.Tensor, kb1: torch.Tensor,
            w2: torch.Tensor, k2: torch.Tensor, kb2: torch.Tensor, cout: int, pool: bool,
            out: torch.Tensor) -> None:
    n, hb, wb, cin = x.shape
    _check_operands(x, w1, k1, kb1, w2, k2, kb2)
    if out.data_ptr() % 16:
        raise ValueError("the fused level-1 kernel needs a 16-byte aligned output")
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ccst_fused_two_conv_s8(
            x.data_ptr(), w1.data_ptr(), k1.data_ptr(), kb1.data_ptr(),
            w2.data_ptr(), k2.data_ptr(), kb2.data_ptr(), out.data_ptr(),
            n, hb, wb, cin, cout, int(pool), stream,
        )
    if rc:
        raise RuntimeError(f"fused level-1 kernel launch failed: CUDA error {rc}")


def encoder_level1(xq_packed: torch.Tensor, q1: QConvS, q2: QConvS,
                   weights: Optional[Level1Weights] = None) -> torch.Tensor:
    """Packed quantized input (N, H/2, W/2, 12) int8 -> pool1 (N, H/2, W/2, 64)
    int8. q1/q2: the packed conv1_1 / conv1_2; ``weights``: their
    :func:`prepare_encoder_level1`, made here when a caller has not kept it."""
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
    lw = weights if weights is not None else prepare_encoder_level1(q1, q2)
    out = torch.empty((n, hb, wb, CMID // 4), dtype=torch.int8, device=xq_packed.device)
    _launch(xq_packed, lw.w1p, q1.k, q1.kb, lw.w2p, lw.k2p, lw.kb2p, CMID, True, out)
    encoder_level1.launches += 1
    return out


def decoder_level1(
    yq: torch.Tensor, q2: QConvS, q1: QConvS, out_dtype: torch.dtype = torch.bfloat16,
    weights: Optional[DecoderLevel1Weights] = None,
) -> torch.Tensor:
    """dconv2_1 output (N, H/2, W/2, 64) int8 -> packed image (N, H/2, W/2, 12)
    in ``out_dtype``. q2/q1: the folded dconv1_2 / packed dconv1_1; ``weights``:
    their :func:`prepare_decoder_level1`, made here when a caller has not kept
    it."""
    if yq.device.type == "cpu":
        return decoder_level1_reference(yq, q2, q1, out_dtype)
    n, hb, wb, cin = yq.shape
    cout = q1.wq.shape[3]
    if (tuple(q2.wq.shape) != (3, 3, D_CIN, CMID) or tuple(q1.wq.shape[:3]) != (3, 3, CMID)
            or cin != D_CIN or cout > NARROW_N or cout % 2 or not q2.requant or q1.requant):
        raise ValueError(
            f"decoder_level1 takes (N, H, W, {D_CIN}) int8, requantizing {D_CIN}->{CMID} and "
            f"dequantizing {CMID}->Cout (Cout even, <= {NARROW_N}) weights, got "
            f"{tuple(yq.shape)}, {tuple(q2.wq.shape)}, {tuple(q1.wq.shape)}"
        )
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the fused level-1 kernel writes bfloat16, not {out_dtype}")
    dw = weights if weights is not None else prepare_decoder_level1(q2, q1)
    out = torch.empty((n, hb, wb, cout), dtype=out_dtype, device=yq.device)
    _launch(yq, dw.w1p, q2.k, q2.kb, dw.w2p, q1.k, q1.kb, cout, False, out)
    decoder_level1.launches += 1
    return out


encoder_level1.launches = 0
decoder_level1.launches = 0
