"""Reflect-pad 3x3 conv + bias + ReLU: CUDA kernel wrapper and plain version.

Replaces ``ccst_tpu/kernels/conv_pallas.py::reflect_conv3x3_fused`` (K3), the
conv of every 3x3 layer in the VGG encoder and decoder. With
``pad_mode="edge"`` it is also the conv of the packed engine's level-1 stage
(``ccst_tpu/models/vgg_fast.py::packed_reflect_conv``), where edge padding of
the space-to-depth plane is reflect padding of the image. The kernel is
``csrc/reflect_conv3x3.cu`` (an implicit GEMM on ``wgmma``, built by
``kernels/_build.py``); its header says what bounds it on the H100 and how the
design answers that. float32 tensors (the engines' verification mode) take the
same source's exact float32 kernels: FFMA sums, no tensor cores, no TF32.

Weights are prepared once per layer (:func:`prepare_conv`): the HWIO tensor for
the plain version, and the kernel's layout (:func:`pack_weight`), picked by the
dtype and Cin: bf16 with Cin a multiple of 8 the stage tiles of
``kernels/igemm_layout.py``; float32 with Cin a multiple of 4 the float32 stage
tiles of :func:`pack_f32_stages`; both are fetched whole, a stage at a time.
Otherwise (conv1_1, Cin = 3, in either dtype) the ``(Kp, Np)`` row-major matrix
of the kernel's scalar-gather paths, rows HWIO's ``(dy, dx, ci)``, zero padded.

:func:`simulate_f32_conv` walks the float32 stage kernel's tiles, threads,
halo planes and weight stages in numpy: the CPU tests hold it to the plain
version, since the kernel itself runs only on the card.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ccst_tpu_torch.kernels import refuse_autograd
from ccst_tpu_torch.kernels.igemm_layout import pack_stage_tiles, pad_index, pick_bn

# csrc/reflect_conv3x3.cu: the narrow output-channel tile of its wgmma path,
# and the tile (BK, BN) its scalar-gather paths pad the weight matrix to.
NARROW_N = 8
TILE_K = 32
TILE_N = 64
# its float32 stage kernel (namespace f32): threads a block, pixels a thread
F32_THREADS = 256
F32_PX = 8


class F32Tile(NamedTuple):
    """The float32 stage kernel's tile for an output-channel width ``bn``
    (``f32::Tile`` in the source)."""

    bn: int
    cg: int      # threads along N; a thread's channels are 4 cg + h bn / 2, h < halves
    halves: int
    pgw: int     # tile rows a warp covers
    twg: int     # pixel groups of 8 along a tile row
    th: int
    tw: int
    ck: int      # input channels a chunk
    rp: int      # floats of a halo row (pixel-major, channels innermost)


def f32_bn(cout: int) -> int:
    """Output channels a block of the float32 stage kernel: 4, 8, 64 or 128."""
    return 4 if cout <= 4 else 8 if cout <= 8 else 64 if cout <= 64 else 128


def f32_tile(bn: int) -> F32Tile:
    cg = bn // 8 if bn >= 64 else 1
    pgw, twg = 32 // cg, 2 if bn >= 64 else 8
    tw, ck = twg * F32_PX, 8 if bn >= 64 else 4
    return F32Tile(bn=bn, cg=cg, halves=2 if bn >= 8 else 1, pgw=pgw, twg=twg,
                   th=F32_THREADS // 32 // twg * pgw, tw=tw, ck=ck, rp=(tw + 2) * ck + 4)


class ConvWeights(NamedTuple):
    """One conv layer, prepared for the compute dtype and device."""

    w: torch.Tensor                 # (kh, kw, Cin, Cout) HWIO, compute dtype
    b: torch.Tensor                 # (Cout,) float32, rounded through the dtype
    packed: Optional[torch.Tensor]  # 3x3 only: the kernel's layout (pack_weight)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def uses_wgmma(cin: int, dtype: torch.dtype) -> bool:
    """The kernel's path is picked by the dtype and Cin alone: bf16 in 16-byte
    channel groups."""
    return dtype == torch.bfloat16 and cin % 8 == 0


def uses_f32_stages(cin: int, dtype: torch.dtype) -> bool:
    """float32 with Cin a multiple of 4 (a pixel's chunk is 16-byte pieces)
    takes the float32 stage kernel."""
    return dtype == torch.float32 and cin % 4 == 0


def pack_f32_stages(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) float32 -> (n tiles, chunks, 9, ck, bn), the
    float32 stage kernel's weights: one chunk's stage is one contiguous run,
    [tap][input channel][output channel], zero past Cin and Cout."""
    kh, kw, cin, cout = w_hwio.shape
    t = f32_tile(f32_bn(cout))
    chunks, tiles = -(-cin // t.ck), -(-cout // t.bn)
    padded = w_hwio.new_zeros((kh * kw, chunks * t.ck, tiles * t.bn))
    padded[:, :cin, :cout] = w_hwio.reshape(kh * kw, cin, cout)
    return padded.reshape(kh * kw, chunks, t.ck, tiles, t.bn).permute(3, 1, 0, 2, 4).contiguous()


def unpack_f32_stages(packed: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """Inverse of :func:`pack_f32_stages`: back to HWIO (3, 3, cin, cout)."""
    tiles, chunks, taps, ck, bn = packed.shape
    w = packed.permute(2, 1, 3, 0, 4).reshape(taps, chunks * ck, tiles * bn)
    return w[:, :cin, :cout].reshape(3, 3, cin, cout).contiguous()


def simulate_f32_conv(x: np.ndarray, packed: np.ndarray, cout: int,
                      reflect: bool = True) -> np.ndarray:
    """The sums the float32 stage kernel forms, (N, H, W, cout), without bias:
    per block its reflected (or edge-padded) halo chunk by chunk in the pixel-major plane of
    pitch ``rp``, each thread's 8 pixels of one tile row and its channels
    ``4 cg + h bn / 2 + j``, each tap as an offset ``dy * rp + dx * ck`` into
    the plane, the weights read from the chunk's stage, and the sums taken
    chunk, then tap, then channel."""
    n_img, h, w, cin = x.shape
    tiles, chunks, taps, ck, bn = packed.shape
    t = f32_tile(bn)
    assert ck == t.ck
    tid = np.arange(F32_THREADS)
    warp, lane = tid // 32, tid % 32
    cg, hx = lane % t.cg, warp % t.twg
    row = warp // t.twg * t.pgw + lane // t.cg
    i = np.arange(F32_PX)
    cols = (4 * cg[:, None] + t.bn // 2 * np.arange(t.halves)[None, :])[:, :, None] + np.arange(4)
    out = np.zeros((n_img, h, w, tiles * bn), x.dtype)
    for n in range(n_img):
        for y0 in range(0, h, t.th):
            for x0 in range(0, w, t.tw):
                gy = pad_index(y0 - 1 + np.arange(t.th + 2), h, reflect)
                gx = pad_index(x0 - 1 + np.arange(t.tw + 2), w, reflect)
                patch = x[n][gy][:, gx]                     # (th + 2, tw + 2, cin)
                for nt in range(tiles):
                    acc = np.zeros((F32_THREADS, F32_PX, t.halves, 4), x.dtype)
                    for c in range(chunks):
                        plane = np.zeros((t.th + 2, t.rp), x.dtype).reshape(-1)
                        got = patch[:, :, c * ck:(c + 1) * ck]  # past Cin: zero fill
                        full = np.zeros((t.th + 2, t.tw + 2, ck), x.dtype)
                        full[:, :, :got.shape[2]] = got
                        plane.reshape(t.th + 2, t.rp)[:, :(t.tw + 2) * ck] = full.reshape(t.th + 2, -1)
                        stage = packed[nt, c]                # (9, ck, bn)
                        for tap in range(taps):
                            dy, dx = divmod(tap, 3)
                            start = (row + dy) * t.rp + (hx * F32_PX + dx) * ck
                            a = plane[start[:, None, None] + i[None, :, None] * ck
                                      + np.arange(ck)[None, None, :]]      # (256, 8, ck)
                            b = stage[tap][:, cols]                        # (ck, 256, halves, 4)
                            acc += np.einsum("tiq,qthj->tihj", a, b)
                    # thread t's pixel i, its channel (h, j): stored where inside the image
                    oy = y0 + row                                          # (256,)
                    ox = x0 + hx[:, None] * F32_PX + i[None, :]            # (256, 8)
                    tt, ii = np.nonzero((oy[:, None] < h) & (ox < w))
                    co = (nt * bn + cols[tt]).reshape(len(tt), -1)
                    out[n, oy[tt][:, None], ox[tt, ii][:, None], co] = acc[tt, ii].reshape(len(tt), -1)
    return out[..., :cout]


def pack_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) bf16 or float32 -> the kernel's weights: stage
    tiles (n tiles, chunks, 9, 8, BN, 8) for bf16 with Cin % 8 == 0, float32
    stage tiles (n tiles, chunks, 9, ck, bn) for float32 with Cin % 4 == 0,
    else the zero-padded (Kp, Np) matrix of the gather paths, in the weights'
    dtype."""
    kh, kw, cin, cout = w_hwio.shape
    if uses_wgmma(cin, w_hwio.dtype):
        return pack_stage_tiles(w_hwio, pick_bn(cout, NARROW_N))
    if uses_f32_stages(cin, w_hwio.dtype):
        return pack_f32_stages(w_hwio)
    k = kh * kw * cin
    out = w_hwio.new_zeros((_round_up(k, TILE_K), _round_up(cout, TILE_N)))
    out[:k, :cout] = w_hwio.reshape(k, cout)
    return out


def _tensor(a) -> torch.Tensor:
    # numpy views of JAX arrays are read-only; torch wants its own copy
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def prepare_conv(w_hwio, b, dtype: torch.dtype, device) -> ConvWeights:
    """Cast once to ``dtype`` on ``device``. The bias is rounded through
    ``dtype`` and kept in float32, as the JAX engine casts every weight to the
    compute dtype and its conv adds the bias in float32."""
    w = _tensor(w_hwio).to(device=device, dtype=dtype).contiguous()
    b = _tensor(b).to(device=device, dtype=dtype).float().contiguous()
    packed = pack_weight(w).contiguous() if w.shape[0] == 3 else None
    return ConvWeights(w=w, b=b, packed=packed)


_TORCH_PAD = {"reflect": "reflect", "edge": "replicate"}


def reflect_conv3x3_reference(
    x: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor, relu: bool = True,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Plain version: torch ReflectionPad2d(1) (``pad_mode="edge"``:
    ReplicationPad2d(1)) + 3x3 conv on the operands upcast to float32, +
    float32 bias, optional ReLU, one rounding to x.dtype."""
    xf = x.float().permute(0, 3, 1, 2)
    xf = F.pad(xf, (1, 1, 1, 1), mode=_TORCH_PAD[pad_mode])
    wf = w_hwio.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = F.conv2d(xf, wf) + b.float().view(1, -1, 1, 1)
    if relu:
        out = torch.relu(out)
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def reflect_conv3x3(
    x: torch.Tensor, cw: ConvWeights, relu: bool = True, pad_mode: str = "reflect"
) -> torch.Tensor:
    """(N, H, W, Cin) -> (N, H, W, Cout) in x.dtype; the CUDA kernel on a CUDA
    tensor (bf16 on the tensor cores, float32 exact; weights prepared in the
    same dtype), the plain version on a CPU tensor. ``pad_mode``:
    ``"reflect"`` or ``"edge"``. Raises if an operand requires grad under grad
    mode: the kernel has no backward."""
    if pad_mode not in _TORCH_PAD:
        raise ValueError(f"pad_mode must be 'reflect' or 'edge', got {pad_mode!r}")
    refuse_autograd("reflect_conv3x3", x, cw.w, cw.b)
    if x.device.type == "cpu":
        return reflect_conv3x3_reference(x, cw.w, cw.b, relu, pad_mode)
    n, h, w, cin = x.shape
    kh, kw, wcin, cout = cw.w.shape
    if (kh, kw, wcin) != (3, 3, cin):
        raise ValueError(f"weights {tuple(cw.w.shape)} do not fit input {tuple(x.shape)}")
    if pad_mode == "reflect" and (h < 2 or w < 2):
        raise ValueError(f"reflection padding needs H, W >= 2, got {h}x{w}")
    if x.dtype not in (torch.bfloat16, torch.float32) or cw.packed.dtype != x.dtype:
        raise TypeError("the CUDA conv kernel takes bfloat16 or float32 with weights of the "
                        f"same dtype, got {x.dtype} and {cw.packed.dtype}")
    if not x.is_contiguous():
        raise ValueError("the CUDA conv kernel takes a contiguous NHWC tensor")
    for t in (cw.packed, cw.b):
        if t.device != x.device:
            raise ValueError("weights and input are on different devices")
    if x.data_ptr() % 16 or cw.packed.data_ptr() % 16:
        raise ValueError("the CUDA conv kernel needs 16-byte aligned operands")
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        entry = (lib.ccst_reflect_conv3x3_f32 if x.dtype == torch.float32
                 else lib.ccst_reflect_conv3x3_bf16)
        rc = entry(
            x.data_ptr(), cw.packed.data_ptr(), cw.b.data_ptr(), y.data_ptr(),
            n, h, w, cin, cout, int(relu), int(pad_mode == "reflect"), stream,
        )
    if rc:
        raise RuntimeError(f"reflect_conv3x3 launch failed: CUDA error {rc}")
    reflect_conv3x3.launches += 1
    return y


reflect_conv3x3.launches = 0
