"""Tiled GEMM ``y = x @ w`` on tensor cores: CUDA kernel wrapper and plain
version (B1).

Replaces ``benchmarks/pallas_int8_mxu.py::pallas_mm``, the JAX project's probe
of whether a hand-written int8 matmul reaches the int8 peak. Three variants,
as there:

  - int8 x int8 -> int32 (exact integer accumulation);
  - int8 x int8 -> float32 (int32 accumulation, converted once);
  - bfloat16 x bfloat16 -> float32 (float32 accumulation).

The kernel is ``csrc/int8_mm.cu`` (``wgmma`` on int8 or bf16 tensor cores from
a ring of shared-memory stages that a producer thread fills through the Tensor
Memory Accelerator, built by ``kernels/_build.py``); its header says what
bounds it on the H100 (device memory, at every shape of the probe) and what the
design does about that. It takes the weights in its own layout, made once by
:func:`prepare_mm_weight` (:func:`pack_mm_weight`): the bytes of its
shared-memory stages, which it fetches whole. Any M runs (rows past M arrive as
zeros and are never stored); K must be a multiple of 16 bytes of the element
type and N a multiple of 8.

:func:`simulate_mm` walks the kernel's work items, A planes and packed weight
stages in numpy: the executable description of its addressing, which the CPU
tests hold against the plain version since the kernel runs only on the card.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ccst_tpu_torch.kernels.igemm_layout import pack_stage_tiles

# Tile sizes of csrc/int8_mm.cu: a work item is TILE_M rows (64 per consumer
# warpgroup) by TILE_N columns; a stage holds 128 bytes of K.
TILE_M = 192
TILE_N = 128

# (input dtype, output dtype) -> the C entry point's ``kind``
_KINDS = {
    (torch.int8, torch.int32): 0,
    (torch.int8, torch.float32): 1,
    (torch.bfloat16, torch.float32): 2,
}


class MMWeight(NamedTuple):
    """A GEMM right-hand side on a device."""

    w: torch.Tensor   # (K, N) int8 or bfloat16, as given
    wt: torch.Tensor  # the kernel's layout (pack_mm_weight)


def pack_mm_weight(w: torch.Tensor) -> torch.Tensor:
    """(K, N) -> (n tiles, chunks, 8, TILE_N, 16 / itemsize), contiguous: the
    bytes of every weight stage as the kernel holds them in shared memory,
    K-major (a 16-byte group's k innermost), zero where K ends inside a
    128-byte chunk or N inside a tile. It is the conv core's layout
    (``igemm_layout.pack_stage_tiles``) with one tap."""
    return pack_stage_tiles(w[None, None], TILE_N)[:, :, 0]


def unpack_mm_weight(packed: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_mm_weight`: back to (k, n)."""
    tiles, chunks, groups, bn, per_group = packed.shape
    w = packed.permute(1, 2, 4, 0, 3).reshape(chunks * groups * per_group, tiles * bn)
    return w[:k, :n].contiguous()


def prepare_mm_weight(w: torch.Tensor) -> MMWeight:
    """(K, N) int8 or bfloat16 -> :class:`MMWeight` on ``w``'s device."""
    if w.dtype not in (torch.int8, torch.bfloat16) or w.dim() != 2:
        raise TypeError(f"prepare_mm_weight takes a 2-D int8 or bfloat16 matrix, got "
                        f"{w.dtype} {tuple(w.shape)}")
    return MMWeight(w=w.contiguous(), wt=pack_mm_weight(w))


def swizzle128(row: np.ndarray, piece: np.ndarray) -> np.ndarray:
    """Index of 16-byte ``piece`` (0..7) of ``row`` in an A stage, in 16-byte
    units: the 128-byte swizzle the tensor map writes and the kernel's A
    descriptor reads. Row r starts at 8 r; its pieces are permuted by r % 8."""
    return 8 * row + (piece ^ (row % 8))


def simulate_mm(x: np.ndarray, packed: np.ndarray, n_cols: int) -> np.ndarray:
    """The sums the kernel forms, (M, n_cols) in ``x.dtype`` (use float64 or
    int64, one element per int8 / bf16 value): per work item and 128-byte
    chunk of K the A stage as the tensor map delivers it (``TILE_M`` rows of
    eight swizzled 16-byte pieces, zero past M and past K), a consumer
    warpgroup's 64 rows read back through the same swizzle, and the weights
    read from ``packed`` as the kernel's descriptors walk them."""
    m, k = x.shape
    tiles, chunks, groups, bn, per_group = packed.shape
    per_chunk = groups * per_group
    out = np.zeros((m, tiles * bn), x.dtype)
    r = np.arange(64)
    for m0 in range(0, m, TILE_M):
        rows = np.arange(min(TILE_M, m - m0))
        for t in range(tiles):
            acc = np.zeros((TILE_M // 64, 64, bn), x.dtype)
            for c in range(chunks):
                stage = np.zeros((TILE_M * groups, per_group), x.dtype)
                for grp in range(groups):
                    k0 = c * per_chunk + grp * per_group
                    if k0 < k:  # K is a whole number of 16-byte groups
                        stage[swizzle128(rows, grp)] = x[m0 + rows, k0:k0 + per_group]
                for wg in range(TILE_M // 64):
                    a = np.stack([stage[swizzle128(64 * wg + r, grp)] for grp in range(groups)])
                    acc[wg] += np.einsum("grk,gnk->rn", a, packed[t, c])
            out[m0 + rows, t * bn:(t + 1) * bn] = acc.reshape(TILE_M, bn)[rows]
    return out[:, :n_cols]


def tiled_mm_reference(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: a float64 product of the input values, cast to
    ``out_dtype``. For int8 operands every product and partial sum is an
    integer below 2**53 (|sum| <= 127**2 * K), so it is exact and equals the
    int32 accumulation; its cast to float32 rounds that integer as int32 ->
    float32 does. For bfloat16 operands it is the exactly rounded sum, which
    the kernel's float32 accumulation reproduces wherever the partial sums
    stay exact in float32 (integer-valued operands with sums below 2**24)."""
    return torch.matmul(x.double(), w.double()).to(out_dtype)


def tiled_mm(x: torch.Tensor, mw: MMWeight, out_dtype: torch.dtype) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) in ``out_dtype``: int8 inputs give int32 or
    float32, bfloat16 inputs float32. The CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    kind = _KINDS.get((x.dtype, out_dtype))
    if kind is None or mw.w.dtype != x.dtype:
        raise TypeError(f"tiled_mm takes int8 -> int32/float32 or bfloat16 -> float32, got "
                        f"{x.dtype} @ {mw.w.dtype} -> {out_dtype}")
    if x.dim() != 2 or x.shape[1] != mw.w.shape[0]:
        raise ValueError(f"tiled_mm: x {tuple(x.shape)} does not fit w {tuple(mw.w.shape)}")
    if x.device.type == "cpu":
        return tiled_mm_reference(x, mw.w, out_dtype)
    m, k = x.shape
    n = mw.w.shape[1]
    if (k * x.element_size()) % 16 or n % 8:
        raise ValueError(f"the GEMM kernel needs K a multiple of 16 bytes and N % 8 == 0, "
                         f"got K={k} ({x.dtype}), N={n}")
    if not x.is_contiguous() or not mw.wt.is_contiguous():
        raise ValueError("the GEMM kernel takes contiguous operands")
    if mw.wt.device != x.device:
        raise ValueError("weights and input are on different devices")
    if x.data_ptr() % 16 or mw.wt.data_ptr() % 16:
        raise ValueError("the GEMM kernel needs 16-byte aligned operands")
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ccst_tiled_mm(x.data_ptr(), mw.wt.data_ptr(), y.data_ptr(),
                               m, n, k, kind, stream)
    if rc:
        raise RuntimeError(f"tiled_mm launch failed: CUDA error {rc}")
    tiled_mm.launches += 1
    return y


tiled_mm.launches = 0
