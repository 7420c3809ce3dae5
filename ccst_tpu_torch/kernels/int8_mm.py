"""Tiled GEMM ``y = x @ w`` on tensor cores: CUDA kernel wrapper and plain
version (B1).

Replaces ``benchmarks/pallas_int8_mxu.py::pallas_mm``, the JAX project's probe
of whether a hand-written int8 matmul reaches the int8 peak. Three variants,
as there:

  - int8 x int8 -> int32 (exact integer accumulation);
  - int8 x int8 -> float32 (int32 accumulation, converted once);
  - bfloat16 x bfloat16 -> float32 (float32 accumulation).

The kernel is ``csrc/int8_mm.cu`` (``mma.sync`` on int8 or bf16 tensor cores,
built by ``kernels/_build.py``); its header says what bounds it on the H100.
It takes the weights in its own layout, made once by :func:`prepare_mm_weight`:
an ``(Np, Kp)`` output-column-major matrix, k contiguous, zero padded to the
tile. Any M runs (the ragged last row tile is masked); K must be a multiple of
16 bytes of the element type and N a multiple of 8.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Tile sizes of csrc/int8_mm.cu: BN output columns; BK bytes of the reduction.
TILE_N = 128
TILE_K_BYTES = 64

# (input dtype, output dtype) -> the C entry point's ``kind``
_KINDS = {
    (torch.int8, torch.int32): 0,
    (torch.int8, torch.float32): 1,
    (torch.bfloat16, torch.float32): 2,
}


class MMWeight(NamedTuple):
    """A GEMM right-hand side on a device."""

    w: torch.Tensor   # (K, N) int8 or bfloat16, as given
    wt: torch.Tensor  # (Np, Kp) the kernel's layout: row n is column n of w, zero padded


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def prepare_mm_weight(w: torch.Tensor) -> MMWeight:
    """(K, N) int8 or bfloat16 -> :class:`MMWeight` on ``w``'s device."""
    if w.dtype not in (torch.int8, torch.bfloat16) or w.dim() != 2:
        raise TypeError(f"prepare_mm_weight takes a 2-D int8 or bfloat16 matrix, got "
                        f"{w.dtype} {tuple(w.shape)}")
    k, n = w.shape
    kp = _round_up(k, TILE_K_BYTES // w.element_size())
    wt = torch.zeros((_round_up(n, TILE_N), kp), dtype=w.dtype, device=w.device)
    wt[:n, :k] = w.t()
    return MMWeight(w=w.contiguous(), wt=wt)


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
    np_, kp = mw.wt.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ccst_tiled_mm(x.data_ptr(), mw.wt.data_ptr(), y.data_ptr(),
                               m, n, k, kp, np_, kind, stream)
    if rc:
        raise RuntimeError(f"tiled_mm launch failed: CUDA error {rc}")
    tiled_mm.launches += 1
    return y


tiled_mm.launches = 0
