"""int8 3x3 conv as a direct 9-tap GEMM or as Winograd F(2x2, 3x3): CUDA kernel
wrappers and plain versions (B2).

Replaces ``benchmarks/winograd_ab.py::conv_kernel`` (``_direct_kernel`` and
``_wino_kernel``), the JAX project's A/B of int8 Winograd against a direct conv
on the packed conv1_2 shape (256 -> 256 channels). Both compute, per output
channel, ``y = float(acc) * k + kb``, then ``rint``, clip to [0, 127], int8:

  - :func:`conv_direct`: ``acc`` is the int32 9-tap sum over the input, edge
    padded;
  - :func:`conv_wino`: per 2x2 output tile, ``V = B^T d B`` of the 4x4 input
    tile ``d``, requantized as ``clip(rint(V * 0.25), -127, 127)`` int8, 16
    int8 position GEMMs ``M_p = V_p @ U_p`` (int32) and ``acc = A^T M A``;
    ``U`` and its per-channel scale come from :func:`wino_weights`.

Both keep the reference's padding, which is not a centred conv: it pads 2 rows
on top and reads from padded row 0, so output row ``h`` is the edge-padded
conv centred on input row ``h - 1`` (row 0 sees rows 0, 0, 0). Columns are
centred. The port copies this; ``ROADMAP.md`` lists it among the gaps in the
reference.

``mode`` selects what :func:`conv_wino` runs, for the A/B:

  - ``"full"``: the whole algorithm;
  - ``"dots"``: the transform elided: every ``V_p`` is the tile's raw corner
    pixel ``d[0][0]`` (the reference fed a constant slab slice, which depends
    on its tile size; the corner pixel does not);
  - ``"tf"``: the GEMMs elided: ``M_p = V_p[..., :Cout]`` (needs Cout <= Cin).

The kernels are ``csrc/winograd_s8.cu``; its header says what bounds them on
the H100. Both take their weights in the kernels' layout: the direct kernel
K0's ``(Np, Kp)`` matrix (:func:`ccst_tpu_torch.kernels.qconv.gemm_weight`),
the Winograd kernel one ``(Cout, Cin)`` matrix per position
(:func:`wino_gemm_weight`). On a CPU tensor the wrappers compute the plain
version; on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ccst_tpu_torch.kernels.qconv import _check_operands, gemm_weight

# F(2x2, 3x3) transform matrices (benchmarks/winograd_ab.py)
BT = np.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], np.float32)
G2 = np.array([[2, 0, 0], [1, 1, 1], [1, -1, 1], [0, 0, 2]], np.float32)  # 2G
AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)

MODES = ("full", "dots", "tf")
# channel granularity of csrc/winograd_s8.cu (input chunk and output block)
CHANNEL_TILE = 64


def wino_weights(wq: np.ndarray):
    """(3, 3, Cin, Cout) int8 -> (16, Cin, Cout) int8 ``U`` and a per-Cout
    float32 scale: ``U_f = (2G) w (2G)^T`` (integer valued), re-quantized with
    one scale per output channel. Formula for formula
    ``benchmarks/winograd_ab.py::wino_weights``."""
    w = np.asarray(wq, np.float32)
    u = np.einsum("ir,rsco,js->ijco", G2, w, G2)
    u = u.reshape(16, *u.shape[2:])
    su = np.abs(u).max(axis=(0, 1)) / 127.0
    su = np.maximum(su, 1e-12)
    uq = np.clip(np.rint(u / su), -127, 127).astype(np.int8)
    return uq, su.astype(np.float32)


def wino_gemm_weight(uq: np.ndarray) -> np.ndarray:
    """(16, Cin, Cout) int8 -> (16, Cout, Cin): per position, row n holds
    output channel n's weights, k contiguous."""
    return np.ascontiguousarray(np.asarray(uq, np.int8).transpose(0, 2, 1))


class WinoConv(NamedTuple):
    """One conv's weights and epilogue terms for both kernels, on a device."""

    w: torch.Tensor    # (9, Cin, Cout) int8: the direct kernel's taps
    u: torch.Tensor    # (16, Cin, Cout) int8: Winograd's U
    k_dir: torch.Tensor   # (Cout,) f32 epilogue multiplier of the direct conv
    k_wino: torch.Tensor  # (Cout,) f32 epilogue multiplier of the Winograd conv
    kb: torch.Tensor      # (Cout,) f32 additive term, shared
    wt: torch.Tensor   # direct kernel layout (Np, Kp)
    ut: torch.Tensor   # Winograd kernel layout (16, Cout, Cin)


def make_wino_conv(wq, uq, k_dir, k_wino, kb, device) -> WinoConv:
    """A :class:`WinoConv` on ``device`` from numpy arrays: ``wq`` (3, 3, Cin,
    Cout) int8, ``uq`` from :func:`wino_weights`, the three (Cout,) terms."""
    wq = np.asarray(wq, np.int8)
    cin, cout = wq.shape[2:]

    def dev(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return WinoConv(
        w=dev(wq.reshape(9, cin, cout), np.int8), u=dev(uq, np.int8),
        k_dir=dev(k_dir, np.float32), k_wino=dev(k_wino, np.float32), kb=dev(kb, np.float32),
        wt=dev(gemm_weight(wq), np.int8), ut=dev(wino_gemm_weight(uq), np.int8),
    )


def _pad_offset(x: torch.Tensor, bottom: int, right: int) -> torch.Tensor:
    """Edge padding as the reference lays it out: 2 rows on top, 1 column on
    the left. NHWC int8 -> NCHW float64."""
    return F.pad(x.permute(0, 3, 1, 2).double(), (1, right, 2, bottom), mode="replicate")


def _requant_relu(acc: torch.Tensor, k: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """float32 epilogue as two separate operations, rint, clip to [0, 127]."""
    y = acc.float() * k
    y = y + kb
    return torch.clamp(torch.round(y), 0.0, 127.0).to(torch.int8)


def conv_direct_reference(x: torch.Tensor, c: WinoConv) -> torch.Tensor:
    """Plain direct conv: a float64 conv of the int8 values (exact, see
    ``kernels/qconv.py``), then the epilogue. Output row h reads input rows
    h-2..h (edge clamped), columns w-1..w+1."""
    n, hb, wb, cin = x.shape
    cout = c.w.shape[2]
    acc = F.conv2d(_pad_offset(x, 0, 1), c.w.double().reshape(3, 3, cin, cout).permute(3, 2, 0, 1))
    return _requant_relu(acc.permute(0, 2, 3, 1), c.k_dir, c.kb).contiguous()


def conv_wino_reference(x: torch.Tensor, c: WinoConv, mode: str = "full") -> torch.Tensor:
    """Plain Winograd conv: the transform in float64 (integer valued, exact),
    V's requant, the 16 position products in float64 (exact integers), the
    inverse transform, then the epilogue."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n, hb, wb, cin = x.shape
    cout = c.u.shape[2]
    th, tw = -(-hb // 2), -(-wb // 2)  # 2x2 output tiles
    xp = _pad_offset(x, 2 * th - hb, 2 * tw - wb + 1).permute(0, 2, 3, 1)
    # d[r][c]: (N, th, tw, Cin), the input tile's element (r, c) for every tile
    d = [[xp[:, r:r + 2 * th:2, cc:cc + 2 * tw:2] for cc in range(4)] for r in range(4)]
    if mode == "dots":
        v = [d[0][0]] * 16
    else:
        bt = BT.astype(np.int64)
        v = []
        for i in range(4):
            for j in range(4):
                s = sum(int(bt[i, r] * bt[j, cc]) * d[r][cc] for r in range(4) for cc in range(4))
                v.append(torch.clamp(torch.round(s * 0.25), -127.0, 127.0))
    u = c.u.double()
    acc = [[0, 0], [0, 0]]
    for p in range(16):
        i, j = divmod(p, 4)
        m_p = v[p][..., :cout] if mode == "tf" else torch.matmul(v[p], u[p])
        for a in (0, 1):
            for b in (0, 1):
                coef = int(AT[a, i] * AT[b, j])
                if coef:
                    acc[a][b] = acc[a][b] + coef * m_p
    # interleave the four phases: output (2ti + a, 2tj + b)
    y = torch.stack([torch.stack([acc[0][0], acc[0][1]], 3),
                     torch.stack([acc[1][0], acc[1][1]], 3)], 2)  # (N, th, 2, tw, 2, Cout)
    y = y.reshape(n, 2 * th, 2 * tw, cout)[:, :hb, :wb]
    return _requant_relu(y, c.k_wino, c.kb).contiguous()


def _launch(x: torch.Tensor, c: WinoConv, wino: bool, mode: str) -> torch.Tensor:
    n, hb, wb, cin = x.shape
    cout = c.w.shape[2]
    if tuple(c.w.shape[:2]) != (9, cin):
        raise ValueError(f"weights {tuple(c.w.shape)} do not fit input {tuple(x.shape)}")
    if cin % CHANNEL_TILE or cout % CHANNEL_TILE:
        raise ValueError(f"the Winograd/direct kernels need Cin and Cout multiples of "
                         f"{CHANNEL_TILE}, got {cin}, {cout}")
    if wino and mode == "tf" and cout > cin:
        raise ValueError(f"mode 'tf' needs Cout <= Cin, got {cout} > {cin}")
    _check_operands(x, c.wt, c.ut, c.k_dir, c.k_wino, c.kb)
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    y = torch.empty((n, hb, wb, cout), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ccst_winograd_s8(
            x.data_ptr(), (c.ut if wino else c.wt).data_ptr(),
            (c.k_wino if wino else c.k_dir).data_ptr(), c.kb.data_ptr(), y.data_ptr(),
            n, hb, wb, cin, cout, c.wt.shape[1], int(wino), MODES.index(mode), stream,
        )
    if rc:
        raise RuntimeError(f"{'Winograd' if wino else 'direct'} conv launch failed: CUDA error {rc}")
    return y


def conv_direct(x: torch.Tensor, c: WinoConv) -> torch.Tensor:
    """(N, H, W, Cin) int8 -> (N, H, W, Cout) int8, the direct 9-tap conv
    with the reference's offset. The CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return conv_direct_reference(x, c)
    y = _launch(x, c, False, "full")
    conv_direct.launches += 1
    return y


def conv_wino(x: torch.Tensor, c: WinoConv, mode: str = "full") -> torch.Tensor:
    """(N, H, W, Cin) int8 -> (N, H, W, Cout) int8 through Winograd F(2x2,
    3x3), ``mode`` as in the module docstring. The CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.device.type == "cpu":
        return conv_wino_reference(x, c, mode)
    y = _launch(x, c, True, mode)
    conv_wino.launches += 1
    return y


conv_direct.launches = 0
conv_wino.launches = 0
