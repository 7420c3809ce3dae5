"""Host side of ``csrc/conv_igemm_sm90.cuh``, the ``wgmma`` core of the 3x3 conv
kernels (K3 bf16, K0 int8, the second conv inside the fused level-1 kernels K1
and K2, and the conv of the fused pool1 + conv2_1 kernel B3): its tile
constants, the packed weight layout, and a numpy model of the kernel's
addressing.

The kernel works in bytes. A block computes 8 rows x 16 pixels for ``BN``
output channels; per chunk of 128 bytes of input channels (64 bf16, 128 int8)
it gathers the tile's 10 x 18 halo into shared memory as ``sA[group of 16
bytes][halo pixel][16 bytes]`` and multiplies every tap against one stage of
weights, which it fetches as one contiguous run of bytes. :func:`pack_stage_tiles`
writes those runs: ``(n tile, chunk, tap, 8 groups of 16 bytes of K, BN, 16
bytes)``, zero where Cin or Cout end inside a chunk or a tile.

:func:`simulate_conv` walks the same tiles, halo indices, planes and weight
runs in numpy. It is the executable description of the addressing that the
CPU tests hold against the plain versions, since the kernel itself runs only
on the card.

:func:`level1_column_order` is the order of conv1_2's output columns in K1's
packed weights, which puts the four phases of a channel into one thread's
accumulator registers.
"""
from __future__ import annotations

import numpy as np
import torch

TILE_H, TILE_W = 8, 16          # output pixels of a block; 8 x 8 per warpgroup
HALO_W = TILE_W + 2
HALO_PX = (TILE_H + 2) * HALO_W
PLANE_SLOTS = HALO_PX + 1       # pixel slots of one 16-byte plane (odd: no bank conflicts)
GROUPS = 8                      # 16-byte groups per pixel and chunk
GROUP_BYTES = 16
CHUNK_BYTES = GROUPS * GROUP_BYTES


def pick_bn(cout: int, narrow: int) -> int:
    """Output-channel tile: ``narrow`` (8 for bf16, 16 for int8) for the
    few-channel layers, else 64 or 128. Mirrors ``ccst_igemm::pick_bn``."""
    return narrow if cout <= narrow else (64 if cout <= 64 else 128)


def pack_stage_tiles(w_hwio: torch.Tensor, bn: int, groups: int = GROUPS) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> (n tiles, chunks, 9, groups, bn, 16 /
    itemsize), contiguous: the bytes of every stage as the kernel holds them in
    shared memory, K-major (the group's channels innermost). ``groups`` is 8, a
    full 128-byte chunk, or 4 for the mainloop's 64-byte mode (a resident tile
    of at most 64 bytes of channels: one chunk, no zero half)."""
    kh, kw, cin, cout = w_hwio.shape
    per_group = GROUP_BYTES // w_hwio.element_size()
    per_chunk = groups * per_group
    chunks, tiles = -(-cin // per_chunk), -(-cout // bn)
    padded = w_hwio.new_zeros((kh * kw, chunks * per_chunk, tiles * bn))
    padded[:, :cin, :cout] = w_hwio.reshape(kh * kw, cin, cout)
    return (padded.reshape(kh * kw, chunks, groups, per_group, tiles, bn)
            .permute(4, 1, 0, 2, 5, 3).contiguous())


def unpack_stage_tiles(packed: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """Inverse of :func:`pack_stage_tiles`: back to HWIO (3, 3, cin, cout)."""
    tiles, chunks, taps, groups, bn, per_group = packed.shape
    w = packed.permute(2, 1, 3, 5, 0, 4).reshape(taps, chunks * groups * per_group, tiles * bn)
    return w[:, :cin, :cout].reshape(3, 3, cin, cout).contiguous()


def pad_index(i: np.ndarray, n: int, reflect: bool) -> np.ndarray:
    """Padded position -> index, then clamped (``ccst_igemm::pad_index``)."""
    if reflect:
        i = np.where(i < 0, -i, np.where(i >= n, 2 * n - 2 - i, i))
    return np.clip(i, 0, n - 1)


def simulate_conv(x: np.ndarray, packed: np.ndarray, cout: int, reflect: bool,
                  row_shift: int = 0, up: bool = False) -> np.ndarray:
    """The sums the kernel forms, (N, H, W, cout) in ``x.dtype`` (use float64
    or int64): per block the halo gather by index, the planes, each tap as a
    start slot ``dy * 18 + dx`` into them, the rows of a warpgroup's 64 as
    ``start + (r // 8) * 18 + r % 8``, and the weights read from ``packed``
    as the kernel's descriptors walk it. ``row_shift`` is ``ConvGeom``'s:
    output row h is the conv centred on input row h - row_shift. ``up`` is
    ``ConvGeom::up``: the output is (N, 2H, 2W, cout), and halo position i
    of an axis of length 2H reads ``x`` at ``pad_index(i, 2H) >> 1``."""
    n_img, h, w, cin = x.shape
    h, w = h << up, w << up
    tiles, chunks, taps, groups, bn, per_group = packed.shape
    per_chunk = groups * per_group
    out = np.zeros((n_img, h, w, tiles * bn), x.dtype)
    r = np.arange(64)
    for n in range(n_img):
        for y0 in range(0, h, TILE_H):
            for x0 in range(0, w, TILE_W):
                p = np.arange(HALO_PX)
                gy = pad_index(y0 - 1 - row_shift + p // HALO_W, h, reflect) >> up
                gx = pad_index(x0 - 1 + p % HALO_W, w, reflect) >> up
                acc = np.zeros((2, 64, tiles * bn), x.dtype)
                for c in range(chunks):
                    planes = np.zeros((groups, PLANE_SLOTS, per_group), x.dtype)
                    for grp in range(groups):
                        c0 = c * per_chunk + grp * per_group
                        if c0 < cin:  # past Cin the copy zero-fills
                            got = x[n, gy, gx, c0:c0 + per_group]
                            planes[grp, :HALO_PX, :got.shape[1]] = got
                    for tap in range(taps):
                        dy, dx = divmod(tap, 3)
                        for wg in range(2):
                            slots = dy * HALO_W + dx + 8 * wg + (r // 8) * HALO_W + r % 8
                            a = planes[:, slots, :]                  # (groups, 64, per_group)
                            for t in range(tiles):
                                b = packed[t, c, tap]                # (groups, bn, per_group)
                                acc[wg, :, t * bn:(t + 1) * bn] += np.einsum("grk,gnk->rn", a, b)
                for wg in range(2):
                    oy, ox = y0 + r // 8, x0 + 8 * wg + r % 8
                    ok = (oy < h) & (ox < w)
                    out[n, oy[ok], ox[ok]] = acc[wg, ok]
    return out[..., :cout]


def requant_relu(acc: np.ndarray, k: np.ndarray, kb: np.ndarray) -> np.ndarray:
    """The int8 kernels' requant with ReLU on integer sums: two float32
    roundings (``float(acc) * k``, ``+ kb``), rint, clip to [0, 127]."""
    y = acc.astype(np.float32) * k.astype(np.float32)
    y = y + kb.astype(np.float32)
    return np.clip(np.rint(y), 0.0, 127.0).astype(np.int64)


def accumulator_column(j: int, t: int, e: int) -> int:
    """Tile column of a thread's accumulator pair ``j`` (one per 8 columns),
    quad lane ``t`` and element ``e`` of the pair (``Wgmma`` in the header)."""
    return 8 * j + 2 * t + e


def level1_column_order(channels: int = 64, bn: int = 128) -> np.ndarray:
    """``order[column]`` = the output channel of the packed conv1_2 (phase-major,
    ``phase * channels + c``) that K1 computes in that column of its two
    ``bn``-wide passes. A thread of quad lane ``t`` holds columns ``8 j + 2 t +
    e``; with ``j = 4 jc + phase`` its four phases of channel ``16 t + 8 p +
    2 jc + e`` are four of its own registers in pass ``p``, so the phase max
    (pool1) needs no exchange, and after both passes the thread holds channels
    ``16 t .. 16 t + 15`` of its pixels: one 16-byte store."""
    passes = 4 * channels // bn
    order = np.empty(4 * channels, np.int64)
    for p in range(passes):
        for jc in range(bn // 32):
            for phase in range(4):
                for t in range(4):
                    for e in range(2):
                        col = p * bn + accumulator_column(4 * jc + phase, t, e)
                        order[col] = phase * channels + 16 * t + 8 * p + 2 * jc + e
    return order
