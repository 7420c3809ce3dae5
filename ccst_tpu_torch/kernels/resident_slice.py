"""The partition the fused-AdaIN and channel-moments kernels share
(``csrc/resident_slice.cuh``), in Python: its constants, and a numpy model of
the order in which a block sums its rows.

A block owns some rows x one 128-byte channel group (64 bf16 / 32 float32
channels) and sweeps 32 rows at once: thread ``t`` has the 16-byte unit
``t % 8`` of rows ``t // 8, t // 8 + 32, ...``. It sums its rows in order; the
four row lanes of a warp are added as ``(0 + 1) + (2 + 3)``; the eight warps in
order. Every float32 sum of the kernels is one of these block sums or a merge
of block results in a fixed order, so a result is the same bits on every run.
Change a constant here and in the header together.
"""
from __future__ import annotations

import numpy as np

LINE = 128       # bytes of one row of a slice
SWEEP = 32       # rows a block sweeps at once (row lanes)
WARPS = 8
MAX_ROWS = 1784  # rows of a slice one block keeps in its shared memory at most


def channel_groups(c: int, itemsize: int) -> int:
    """Number of 128-byte channel groups of a row of ``c`` channels."""
    per_group = LINE // itemsize
    return -(-c // per_group)


def block_sum(x: np.ndarray) -> np.ndarray:
    """Model of ``block_sum`` after ``sum_rows``: float32 (..., rows, C) ->
    (..., C), added in the kernel's order. Rows past the end add nothing."""
    x = np.asarray(x, np.float32)
    rows, c = x.shape[-2:]
    sweeps = -(-rows // SWEEP)
    pad = [(0, 0)] * (x.ndim - 2) + [(0, sweeps * SWEEP - rows), (0, 0)]
    x = np.pad(x, pad).reshape(*x.shape[:-2], sweeps, SWEEP, c)
    lanes = np.zeros((*x.shape[:-3], SWEEP, c), np.float32)
    for k in range(sweeps):  # a thread's rows, in order
        lanes += x[..., k, :, :]
    q = lanes.reshape(*lanes.shape[:-2], WARPS, 4, c)
    warps = (q[..., 0, :] + q[..., 1, :]) + (q[..., 2, :] + q[..., 3, :])
    total = np.zeros((*warps.shape[:-2], c), np.float32)
    for w in range(WARPS):
        total += warps[..., w, :]
    return total
