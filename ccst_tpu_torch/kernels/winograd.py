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

The direct conv is K0 itself (``csrc/qconv3x3_s8.cu``, edge padding, requant
+ ReLU) launched with a row shift of 1, so it is the production kernel and no
conv of its own; :class:`WinoConv` carries its weights as a K0 layer
(:func:`ccst_tpu_torch.kernels.qconv.make_qconv`). The Winograd conv is
``csrc/winograd_s8.cu``; its header says what bounds it on the H100 and how
the design answers that. It takes ``U`` as host-packed stages
(:func:`pack_wino_stages`), and :func:`simulate_wino` walks its halo planes,
transform, position planes, descriptors and phase sums in numpy, since the
kernel itself runs only on the card. On a CPU tensor the wrappers compute the
plain version; on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ccst_tpu_torch.kernels.qconv import QConvS, _check_operands, launch_qconv, make_qconv

# F(2x2, 3x3) transform matrices (benchmarks/winograd_ab.py)
BT = np.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], np.float32)
G2 = np.array([[2, 0, 0], [1, 1, 1], [1, -1, 1], [0, 0, 2]], np.float32)  # 2G
AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)

MODES = ("full", "dots", "tf")
# csrc/winograd_s8.cu: channels of an input chunk and of a warpgroup's output
# columns (Cin and Cout are multiples of it), output channels a block, output
# pixels a side of a block (8 x 8 Winograd tiles: the 64 rows of a wgmma)
CHANNEL_TILE = 64
WINO_N = 128
WINO_SIDE = 16
POSITIONS = 16
# its shared-memory layouts, in bytes: the halo of a chunk is [16-byte group]
# [row][even columns, then odd columns][16]; V is [position][group][tile][16]
_TT = WINO_SIDE // 2
_HALO_SIDE = WINO_SIDE + 2
_HALO_ODD = _HALO_SIDE // 2 * 16
_HALO_ROW = _HALO_SIDE * 16
_HALO_GROUP = _HALO_SIDE * _HALO_ROW
_V_GROUP = _TT * _TT * 16
_V_POS = 4 * _V_GROUP


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


def pack_wino_stages(uq: np.ndarray) -> np.ndarray:
    """(16, Cin, Cout) int8 -> (n tiles, chunks, 16, 4, 128, 16), the stages
    of ``csrc/winograd_s8.cu``: one position's weights of one 64-channel chunk
    for 128 output channels is one run of 8 KB, [16-byte group of K][output
    channel][16 input channels], zero past Cin and Cout."""
    uq = np.asarray(uq, np.int8)
    _, cin, cout = uq.shape
    chunks, tiles = -(-cin // CHANNEL_TILE), -(-cout // WINO_N)
    padded = np.zeros((POSITIONS, chunks * CHANNEL_TILE, tiles * WINO_N), np.int8)
    padded[:, :cin, :cout] = uq
    return np.ascontiguousarray(
        padded.reshape(POSITIONS, chunks, 4, 16, tiles, WINO_N).transpose(4, 1, 0, 2, 5, 3))


def unpack_wino_stages(up: np.ndarray, cin: int, cout: int) -> np.ndarray:
    """Inverse of :func:`pack_wino_stages`: back to (16, cin, cout)."""
    tiles, chunks = up.shape[:2]
    u = np.asarray(up).transpose(2, 1, 3, 5, 0, 4).reshape(POSITIONS, chunks * CHANNEL_TILE,
                                                             tiles * WINO_N)
    return np.ascontiguousarray(u[:, :cin, :cout])


class WinoConv(NamedTuple):
    """One conv's weights and epilogue terms for both sides of the A/B, on a device."""

    direct: QConvS        # the direct conv as a K0 layer: wq HWIO, k = k_dir, kb, K0's stages
    u: torch.Tensor       # (16, Cin, Cout) int8: Winograd's U
    k_wino: torch.Tensor  # (Cout,) f32 epilogue multiplier of the Winograd conv
    up: torch.Tensor      # U in the Winograd kernel's stages (pack_wino_stages)

    @property
    def kb(self) -> torch.Tensor:
        """(Cout,) f32 additive term, shared by both convs."""
        return self.direct.kb


def make_wino_conv(wq, uq, k_dir, k_wino, kb, device) -> WinoConv:
    """A :class:`WinoConv` on ``device`` from numpy arrays: ``wq`` (3, 3, Cin,
    Cout) int8, ``uq`` from :func:`wino_weights`, the three (Cout,) terms."""
    return WinoConv(
        direct=make_qconv(np.array(wq, np.int8), k_dir, kb, False, True, device),
        u=torch.from_numpy(np.array(uq, np.int8)).to(device),
        k_wino=torch.from_numpy(np.array(k_wino, np.float32)).to(device),
        up=torch.from_numpy(pack_wino_stages(uq)).to(device),
    )


def simulate_wino(x: np.ndarray, up: np.ndarray, cout: int, mode: str = "full") -> np.ndarray:
    """The integer sums the Winograd kernel forms, (N, H, W, cout) int64,
    before its epilogue: per block of 16 x 16 outputs and chunk of 64 input
    channels, the edge-clamped 18 x 18 halo in its byte planes (even columns,
    then odd), each tile's 4 x 4 input read from them as four-channel words,
    V requantized into the 16 position planes, per position and warpgroup two
    k32 products whose A and B are read as the kernel's descriptors walk V
    and the stage of ``up``, summed a row i of positions at a time as the
    kernel's three products (S = M_i0 + M_i1 + M_i2, X = M_i1, R = M_i2 +
    M_i3) and added into the four phases with A^T's signs, and accumulator
    row r stored as tile (r // 8, r % 8). ``mode`` as the kernel's: ``dots``
    puts the raw corner word in every plane, ``tf`` takes M_p from the plane
    of the chunk that holds the warpgroup's channels, position by position."""
    n_img, h, w, cin = x.shape
    tiles, chunks = up.shape[:2]
    stages = np.asarray(up, np.int8).reshape(tiles, chunks, POSITIONS, -1).astype(np.int64)
    x = np.asarray(x, np.int8)
    at = AT.astype(np.int64)
    r, kk, col = np.arange(64), np.arange(32), np.arange(64)
    # descriptor walks, unswizzled and K-major: byte kk of K step ks of row r
    # (A: tile r of V) and of column n of warpgroup wg (B: the stage)
    a_at = [(2 * ks + kk // 16) * _V_GROUP + (r // 8 * 128 + r % 8 * 16)[:, None] + kk % 16
            for ks in (0, 1)]
    b_at = [[(2 * ks + kk // 16) * WINO_N * 16 + ((64 * wg + col) * 16)[:, None] + kk % 16
             for ks in (0, 1)] for wg in (0, 1)]
    tf_at = (col >> 4) * _V_GROUP + (r * 16)[:, None] + (col & 15)  # [tile, channel] of a plane
    hy, hx = np.divmod(np.arange(_HALO_SIDE * _HALO_SIDE), _HALO_SIDE)
    halo_at = hy * _HALO_ROW + (hx & 1) * _HALO_ODD + (hx >> 1) * 16
    grp, tr, tc, k4 = (a.reshape(-1) for a in np.meshgrid(
        np.arange(4), np.arange(_TT), np.arange(_TT), np.arange(4), indexing="ij"))
    d0 = grp * _HALO_GROUP + 2 * tr * _HALO_ROW + tc * 16 + 4 * k4   # a tile's word d[0][0]
    v_at = (grp * _V_GROUP + (tr * _TT + tc) * 16 + 4 * k4)[:, None] + np.arange(4)
    out = np.zeros((n_img, h, w, tiles * WINO_N), np.int64)
    for n in range(n_img):
        for y0 in range(0, h, WINO_SIDE):
            for x0 in range(0, w, WINO_SIDE):
                gy = np.clip(y0 - 2 + hy, 0, h - 1)
                gx = np.clip(x0 - 1 + hx, 0, w - 1)
                acc = np.zeros((tiles, 2, 4, 64, 64), np.int64)  # n tile, warpgroup, phase
                for c in range(chunks):
                    halo = np.zeros(4 * _HALO_GROUP, np.int8)
                    for g in range(4):
                        lo = c * CHANNEL_TILE + 16 * g
                        if lo < cin:
                            halo[g * _HALO_GROUP + halo_at[:, None] + np.arange(16)] = x[n, gy, gx, lo:lo + 16]

                    def d(rr, cc):
                        at_word = d0 + rr * _HALO_ROW + (cc & 1) * _HALO_ODD + (cc >> 1) * 16
                        return halo[at_word[:, None] + np.arange(4)].astype(np.int64)

                    if mode == "dots":
                        vp = [d(0, 0)] * POSITIONS
                    else:
                        t = [[None] * 4 for _ in range(4)]  # B^T d, [row][column]
                        for cc in range(4):
                            d_c = [d(rr, cc) for rr in range(4)]
                            t[0][cc], t[1][cc] = d_c[0] - d_c[2], d_c[1] + d_c[2]
                            t[2][cc], t[3][cc] = d_c[2] - d_c[1], d_c[1] - d_c[3]
                        vp = []
                        for i in range(4):  # (B^T d) B, row i: positions 4 i .. 4 i + 3
                            for v in (t[i][0] - t[i][2], t[i][1] + t[i][2], t[i][2] - t[i][1],
                                      t[i][1] - t[i][3]):
                                vp.append(np.clip(np.rint(v * 0.25), -127, 127))
                    planes = np.zeros(POSITIONS * _V_POS, np.int64)
                    for p in range(POSITIONS):
                        planes[p * _V_POS + v_at] = vp[p]
                    for nt in range(tiles):
                        for wg in (0, 1):
                            if mode == "tf" and c * CHANNEL_TILE != nt * WINO_N + 64 * wg:
                                continue
                            if mode == "tf":
                                for p in range(POSITIONS):
                                    m = planes[p * _V_POS + tf_at]
                                    for a in (0, 1):
                                        for b in (0, 1):
                                            acc[nt, wg, 2 * a + b] += at[a, p // 4] * at[b, p % 4] * m
                                continue

                            def m(p):  # M_p: two k32 products through the descriptors
                                plane, stage = planes[p * _V_POS:(p + 1) * _V_POS], stages[nt, c, p]
                                return sum(plane[a_at[ks]] @ stage[b_at[wg][ks]].T for ks in (0, 1))

                            for i in range(4):
                                s_ = m(4 * i) + m(4 * i + 1) + m(4 * i + 2)
                                x_, r_ = m(4 * i + 1), m(4 * i + 2) + m(4 * i + 3)
                                for a in (0, 1):
                                    acc[nt, wg, 2 * a] += at[a, i] * s_
                                    acc[nt, wg, 2 * a + 1] += at[a, i] * (x_ - r_)
                for a in (0, 1):
                    for b in (0, 1):
                        oy, ox = y0 + 2 * (r // 8) + a, x0 + 2 * (r % 8) + b
                        ok = (oy < h) & (ox < w)
                        for nt in range(tiles):
                            for wg in (0, 1):
                                lo = nt * WINO_N + 64 * wg
                                out[n, oy[ok], ox[ok], lo:lo + 64] = acc[nt, wg, 2 * a + b][ok]
    return out[..., :cout]


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
    acc = F.conv2d(_pad_offset(x, 0, 1), c.direct.wq.double().permute(3, 2, 0, 1))
    return _requant_relu(acc.permute(0, 2, 3, 1), c.direct.k, c.kb).contiguous()


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


def conv_direct(x: torch.Tensor, c: WinoConv) -> torch.Tensor:
    """(N, H, W, Cin) int8 -> (N, H, W, Cout) int8, the direct 9-tap conv
    with the reference's offset: K0's kernel (edge padding, requant + ReLU)
    with a row shift of 1 on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return conv_direct_reference(x, c)
    y = launch_qconv(x, c.direct, True, torch.int8, "edge", row_shift=1)
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
    n, hb, wb, cin = x.shape
    _, ucin, cout = c.u.shape
    if ucin != cin:
        raise ValueError(f"weights {tuple(c.u.shape)} do not fit input {tuple(x.shape)}")
    if cin % CHANNEL_TILE or cout % CHANNEL_TILE:
        raise ValueError(f"the Winograd kernel needs Cin and Cout multiples of {CHANNEL_TILE}, "
                         f"got {cin}, {cout}")
    if mode == "tf" and cout > cin:
        raise ValueError(f"mode 'tf' needs Cout <= Cin, got {cout} > {cin}")
    _check_operands(x, c.up, c.k_wino, c.kb)
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    y = torch.empty((n, hb, wb, cout), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ccst_winograd_s8(x.data_ptr(), c.up.data_ptr(), c.k_wino.data_ptr(),
                                  c.kb.data_ptr(), y.data_ptr(), n, hb, wb, cin, cout,
                                  MODES.index(mode), stream)
    if rc:
        raise RuntimeError(f"Winograd conv launch failed: CUDA error {rc}")
    conv_wino.launches += 1
    return y


conv_direct.launches = 0
conv_wino.launches = 0
