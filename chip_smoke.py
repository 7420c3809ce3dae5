#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``ccst_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and exits non-zero
without one. It imports nothing of JAX. Phases, each of which fails the run:

  1. device: the card's name and power limit (nvidia-smi), TF32 off so the
     float32 plain references are true float32;
  2. build: the CUDA kernel library from ``ccst_tpu_torch/csrc`` (one nvcc
     per source, in parallel);
  3. each kernel against its plain PyTorch version on the card at the shapes
     of the 512 px path, with the median time of both and the kernel's bound
     (the larger of its operations over the card's dense peak and its bytes,
     each input read and each output written once, over 3.35 TB/s): K3 conv at
     every distinct shape of the ``ref`` engine at 512 px, batch 4, cuDNN's
     bf16 conv timed beside it for comparison only, and its exact float32
     route (TF32 off everywhere, rtol = atol = 1e-4) at every shape of the
     path and three ragged ones, cuDNN's float32 conv timed beside each; a
     K3 or K0 row under 0.1 ms is also timed from a replayed CUDA graph
     (``graph_ms``); K4 AdaIN for one and three style banks
     (bf16 and float32, alpha 1.0 and 0.6, the resident and the streamed
     variant, batch 32 and the 256 px map); K5 moments (bf16 and float32,
     C = 512 and 500, batch 32; the same bits from two runs), each beside the
     time of an empty kernel launched the same way; K0 int8 conv at every shape of the int8 engines, K1
     fused level-1 encoder and K2 fused level-1 decoder bit for bit, K2 and
     the two K0 launches it replaces timed on the device from a replayed
     CUDA graph at batch 4 and 32; the int8 A/B
     kernels bit for bit at the harnesses' full-width shapes: B1 tiled GEMM
     (int8 -> int32, int8 -> float32, bf16 -> float32, M = 2^18, the five
     (K, N) of the sweep; beside it, for comparison only, the one library call
     that computes the same function: ``torch._int_mm`` for int8 -> int32 and
     ``torch.mm(x, w, out_dtype=torch.float32)`` for bf16 -> float32; the
     bf16-output ``torch.matmul`` is timed under its own name, since it writes
     half the output bytes), B2 direct (K0's kernel with the reference's row
     offset) and Winograd conv (full, dots, tf) at (8, 256, 256, 256 -> 256),
     each and K0 at the same shape (``k0_ms``) from a replayed CUDA graph,
     B3 fused pool1 + conv2_1 (F9, F3) at (128, 256, 256, 256), the unfused
     chain (phase max + K0) timed beside it; then ragged
     shapes (odd planes, Cout = 12, one-row tiles, M and N off the tiles);
  4. the main paths through the CLI entry point, in this process, each with
     every launch count zeroed before it and read after it: ``style-bank``
     for four synthetic PACS domains, ``stylize --target photo --mode
     overall`` (bf16 ``ref`` engine), ``calibrate --target photo``,
     ``stylize --engine int8-fused`` at 512 px in bfloat16 with seeded random
     weights, then ``style-bank`` and ``stylize --engine ref`` once more with
     ``--dtype float32`` (the parity mode); outputs must exist and be finite, and every kernel's launch
     count must be exactly what the path implies;
  5. on one 512 px batch: the ``ref`` path against the same path composed
     from the plain versions (MAE <= 1e-3), and the same in float32 (MAE <=
     1e-4); ``int8-fused`` against its plain
     composition (MAE <= 1e-3), against ``int8-static`` (bit for bit) and
     against ``ref`` (PSNR > 20 dB); ``apply_decoder_q8s_fused`` (K2) against
     ``apply_decoder_q8s`` (bit for bit) on one AdaIN output, one style's
     decode timed both ways; device-only ``stylize_multi`` times of the three
     engines and of the float32 ``ref`` engine, as a loop of calls and as one
     replayed CUDA graph (the card's own time: the difference is the host's);
  6. the three int8 A/B harnesses (``ccst_tpu_torch.benchmarks.int8_mm``,
     ``winograd_ab``, ``fused_pool_conv_ab --batch 32``) through their
     ``main()`` in this process, each with every launch count zeroed before it
     and read after it; the counts must be the ones its arguments imply.

The random decoder's last conv is rescaled (x12, bias +0.5) so that stylized
outputs spread over [0, 1] as real ones do: the MAE bar is then 0.1% of the
output's range, as it is for a real image, and the PNGs the CLI writes are not
near-constant.

    python3 chip_smoke.py --images-per-domain 32 --batch-size 32

runs the same phases on a larger synthetic tree and batch, for the device
rates at batch 32 and a disk-to-disk rate over more than the first batches.

The line before the last is a JSON object with one entry per kernel, whose
``launches`` are the phase-4 main paths' counts (K2 decodes ``int8-fused``:
on this card it is faster than the two K0 launches it replaces,
``replaces_chain_ms``) and,
for B1-B3, the phase-6 harnesses' counts, and whose ``bound_ms`` / ``bound_by``
/ ``library_ms`` are those of its ``timed_shape``, the one the main paths
launch it at (K4's and K5's is relu4_1 of a ``--batch-size`` batch, K4's with
all three banks in the launch, ``timed_styles``; their ``ms`` is the card's
own time, from a replayed CUDA graph; ``call_ms`` under ``shapes`` is the
host's rate of calls; K2's ``ms`` is device time from a graph too. K3, K0 and
B1 list every main-path shape, K3 also its float32 rows, B1 every variant, K4,
K5, K2, B2 and B3 every timed case, under ``shapes``; B2's rows carry ``k0_ms``);
the last line is ``{"ok": true, "device":
{...}}``.
"""
import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # same bf16 operands, f32 sums in another order
F32_TOL = dict(rtol=1e-5, atol=1e-5)   # K4 in float32: the same maths, sums in another order
# K3 in float32: float32 sums of up to 9 x 512 products in another order than
# cuDNN's (TF32 off on both sides)
K3_F32_TOL = dict(rtol=1e-4, atol=1e-4)
F32_MAE_BAR = 1e-4                     # float32 whole path against its plain path
MAE_BAR = 1e-3                         # ROADMAP.md / BASELINE stylize bar
MIN_SPREAD = 0.5                       # the bar above assumes outputs spread over [0, 1]
PSNR_BAR = 20.0                        # int8 vs bf16 ref, ccst_tpu's tests/test_vgg_fast.py bar
INT8_PEAK_TOPS = 1979.0                # H100 SXM dense int8, NVIDIA data sheet
BF16_PEAK_TFLOPS = 989.0               # H100 SXM dense bf16, NVIDIA data sheet
F32_PEAK_TFLOPS = 67.0                 # H100 SXM float32 outside the tensor cores
HBM_TB_S = 3.35                        # H100 SXM device memory rate
DOMAINS = ("art_painting", "cartoon", "photo", "sketch")
SIZE = 512
DEC_SCALE, DEC_SHIFT = 12.0, 0.5       # last decoder conv: outputs spread over [0, 1]

# K3 at every distinct shape the ``ref`` engine launches at batch 4, 512 px
# (encoder conv1_1..conv4_1, decoder dconv4_1..dconv1_1; 256->256 at 128 px,
# 128->128 at 256 px and 64->64 at 512 px serve both), then a ragged one
K3_SHAPES = [
    ("conv1_1", (4, 512, 512, 3, 64)),
    ("conv1_2, dconv1_2", (4, 512, 512, 64, 64)),
    ("conv2_1", (4, 256, 256, 64, 128)),
    ("conv2_2, dconv2_2", (4, 256, 256, 128, 128)),
    ("conv3_1", (4, 128, 128, 128, 256)),
    ("conv3_2..3_4, dconv3_4..3_2", (4, 128, 128, 256, 256)),
    ("conv4_1", (4, 64, 64, 256, 512)),
    ("dconv4_1", (4, 64, 64, 512, 256)),
    ("dconv3_1", (4, 128, 128, 256, 128)),
    ("dconv2_1", (4, 256, 256, 128, 64)),
    ("dconv1_1", (4, 512, 512, 64, 3)),
    ("ragged", (2, 37, 53, 64, 128)),
]
K3_MAIN = (4, 512, 512, 64, 64)
# K3's float32 route (``--dtype float32``) at every shape of the 512 px path,
# then ragged planes: Cin and Cout off every vector width (the scalar gather),
# Cout = 3 (the narrow tile) on a plane that is no multiple of its 32 x 64 tile
K3_F32_SHAPES = [*((layer, shape) for layer, shape in K3_SHAPES if layer != "ragged"),
                 ("ragged", (2, 37, 53, 64, 128)), ("ragged", (3, 17, 9, 5, 7)),
                 ("ragged Cout = 3", (3, 45, 70, 64, 3))]
GRAPH_BELOW_MS = 0.1  # a kernel row under this also gets its time from a replayed CUDA graph
def relu4_1_shape(batch):
    """What K4 and K5 are given on the 512 px main paths: a batch's relu4_1."""
    return (batch, SIZE // 8, SIZE // 8, 512)


# K4: (shape, dtype name, alpha), each for S = 1 and S = 3 style banks, after
# the main paths' own shape ``relu4_1_shape(--batch-size)`` in both types and
# blends: relu4_1 of the 512 px path at batch 4 and 32, of the 256 px path, and
# maps above 119 x 119, which the kernel streams
K4_CASES = [
    ((4, 64, 64, 512), "bfloat16", 1.0), ((32, 64, 64, 512), "bfloat16", 1.0),
    ((4, 32, 32, 512), "bfloat16", 1.0),
    ((2, 128, 128, 64), "bfloat16", 0.6), ((1, 128, 128, 48), "float32", 1.0),
]
# K5: (shape, dtype name), after the main paths' own shape in both types: the
# bank's batch of 3 (also with rows that are not 16-byte aligned) and of 32
K5_CASES = [
    ((3, 64, 64, 512), "bfloat16"), ((3, 64, 64, 500), "bfloat16"), ((3, 64, 64, 512), "float32"),
    ((3, 64, 64, 500), "float32"), ((32, 64, 64, 512), "bfloat16"),
]
SMALL_REPS = 200  # launches a timing run of the sub-0.1 ms kernels (K4: 50 of S banks)
# K0 at the shapes the int8 engines launch at batch 4, 512 px:
# (layer, (N, H, W, Cin, Cout), pad, requant, relu)
K0_SHAPES = [
    ("conv1_1 packed (int8-static)", (4, 256, 256, 12, 256), "edge", True, True),
    ("conv1_2 packed (int8-static)", (4, 256, 256, 256, 256), "edge", True, True),
    ("conv2_1", (4, 256, 256, 64, 128), "reflect", True, True),
    ("conv2_2", (4, 256, 256, 128, 128), "reflect", True, True),
    ("conv3_1", (4, 128, 128, 128, 256), "reflect", True, True),
    ("conv3_2..3_4, dconv3_4..3_2", (4, 128, 128, 256, 256), "reflect", True, True),
    ("conv4_1 (dequant)", (4, 64, 64, 256, 512), "reflect", False, True),
    ("dconv4_1", (4, 64, 64, 512, 256), "reflect", True, True),
    ("dconv3_1", (4, 128, 128, 256, 128), "reflect", True, True),
    ("dconv2_1", (4, 256, 256, 128, 64), "reflect", True, True),
    ("dconv1_2 folded", (4, 256, 256, 64, 256), "edge", True, True),
    ("dconv1_1 packed (dequant)", (4, 256, 256, 256, 12), "edge", False, False),
]
K0_MAIN = (4, 128, 128, 256, 256)
# ragged K0 shapes, correctness only: odd plane and no ReLU (clip at -127),
# Cout = 12 on an odd plane, the Cin = 12 gather on one row, the smallest
# reflectable plane
K0_EDGE = [
    ((2, 37, 53, 64, 128), "reflect", True, False),
    ((3, 17, 9, 256, 12), "edge", False, False),
    ((1, 1, 5, 12, 256), "edge", True, True),
    ((1, 2, 2, 64, 64), "reflect", True, True),
]
# ragged K1 / K2 planes (packed pixels): not multiples of the 8 x 16 tile,
# 18 rows (which ccst_tpu's row-tile rule rejects), one row; several tiles
# each way with both edges ragged, exactly one tile, one column of tiles; then
# planes that put a tile border on every side of K2's edge-replica fix-up: one
# past a tile each way, exact tiles, 2 x 2
LEVEL1_EDGE = [(1, 18, 10), (2, 7, 33), (1, 1, 3), (2, 19, 37), (1, 8, 16), (1, 250, 6),
               (1, 9, 17), (2, 16, 32), (1, 2, 2)]
K2_BATCHES = (4, 32)  # K2 against the chain it replaces: (batch, 256, 256, 64)
# B1 at the sweep of benchmarks/pallas_int8_mxu.py: (M, K, N); ragged: M not
# a multiple of the 192-row tile, N not of the 128-column tile, K ending
# inside a 128-byte stage in both element types, fewer rows than one wgmma
B1_M = 1 << 18
B1_SHAPES = [(256, 256), (512, 512), (2304, 256), (576, 256), (1152, 128)]
B1_MAIN = [B1_M, 2304, 256]
B1_EDGE = [(1000, 48, 24), (77, 2304, 136), (300, 80, 40), (5, 256, 128)]
# B2 at the packed conv1_2 shape of benchmarks/winograd_ab.py; ragged: odd
# planes (partial 2x2 tiles and 16 x 16 blocks), one row, four chunks with a
# second 128-channel tile half past Cout
B2_MAIN = (8, 256, 256, 256, 256)
B2_EDGE = [(1, 17, 37, 64, 64), (2, 9, 20, 128, 64), (1, 1, 3, 64, 128), (2, 40, 33, 256, 192)]
# B3 at benchmarks/fused_pool_conv_ab.py's B = 128; ragged: odd planes, 2x2
B3_MAIN = (128, 256, 256)
B3_EDGE = [(1, 7, 13), (2, 2, 2), (3, 33, 5)]
# B3's other output-channel tiles: BN = 64, the narrow BN = 16 (nine taps a stage), two n tiles
B3_EDGE_COUT = [(1, 7, 13, 64), (2, 2, 2, 12), (3, 33, 5, 136), (2, 17, 35, 64)]
HARNESS_REPS = ["--reps", "5", "--runs", "3"]
B3_HARNESS_BATCH = 32


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def bound(ops, peak_tera, nbytes):
    """The least time in ms the card could take: ``ops`` operations at
    ``peak_tera`` (1e12 per second) or ``nbytes`` at the device memory rate,
    whichever is larger, and which of the two it is."""
    t_ops, t_bytes = ops / (peak_tera * 1e12) * 1e3, nbytes / (HBM_TB_S * 1e12) * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def conv_bound(shape, peak_tera, in_bytes, out_bytes):
    """Bound of a 3x3 conv (N, H, W, Cin -> Cout): 2 * 9 * Cin * Cout
    operations a pixel; the input, the weights, the per-channel f32 terms
    and the output each moved once."""
    n, h, w, cin, cout = shape
    nbytes = n * h * w * (cin * in_bytes + cout * out_bytes) + 9 * cin * cout * in_bytes + 8 * cout
    return bound(2 * n * h * w * 9 * cin * cout, peak_tera, nbytes)


def check_close(name, got, want, rtol, atol):
    """Elementwise |got - want| <= atol + rtol * |want| in float32; returns
    (max abs err, mean abs err)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(got.isfinite().all()):
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        fail(f"{name}: max abs err {err.max().item():.3e} exceeds rtol={rtol} atol={atol}")
    return err.max().item(), err.mean().item()


def check_equal(torch, name, got, want):
    """Bit for bit: same shape, dtype and values; returns the max abs err (0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    if not torch.equal(got, want):
        diff = (got.float() - want.float()).abs()
        fail(f"{name}: differs from its plain version at {int((diff > 0).sum())} elements, "
             f"max abs err {diff.max().item():.3e}")
    return 0.0


def time_ms(torch, fn, reps=10, runs=5):
    """Median over ``runs`` of the mean device time of ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def write_tree(root, images_per_domain):
    """A PACS-layout tree: ``PACS/kfold/{domain}/dog/img{i}.png`` (blocky
    seeded noise, 512 px) and ``txt_lists/pacs/{domain}_train.txt`` lines
    ``<rel> <label>``."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    for d in DOMAINS:
        rels = []
        for i in range(images_per_domain):
            rel = f"PACS/kfold/{d}/dog/img{i}.png"
            base = rng.random((SIZE // 16, SIZE // 16, 3), dtype=np.float32)
            img = np.kron(base, np.ones((16, 16, 1), np.float32))
            img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1) * 255 + 0.5
            os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(os.path.join(root, rel))
            rels.append(rel)
        list_path = os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt")
        os.makedirs(os.path.dirname(list_path), exist_ok=True)
        with open(list_path, "w") as f:
            f.writelines(f"{rel} 0\n" for rel in rels)


def read_images(paths):
    """(N, SIZE, SIZE, 3) uint8 from PNGs written at SIZE."""
    import numpy as np
    from PIL import Image

    return np.stack([np.asarray(Image.open(p).convert("RGB"), dtype=np.uint8) for p in paths])


def cudnn_bf16_conv(torch, x, cw):
    """A timing reference only, on no path: cuDNN's conv in x's dtype
    (channels_last) on an input reflect-padded beforehand, bias in the conv,
    no ReLU."""
    F = torch.nn.functional
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    xp = xp.contiguous(memory_format=torch.channels_last)
    w = cw.w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b = cw.b.to(x.dtype)
    return lambda: F.conv2d(xp, w, b)


def check_small_kernels(torch, dev, gen, results, batch):
    """Phase 3, K4 and K5: the fused AdaIN for one and three style banks and
    the channel moments against their plain versions, first at the shape the
    main paths launch them at with ``batch`` images a batch, with times beside the
    bound and beside an empty kernel launched through the same ctypes route.
    Both kernels take less time on the card than the host needs to make a
    call, so each gets two times: ``ms``, the card's own, from calls captured
    into one CUDA graph and replayed, and ``call_ms``, back-to-back calls of
    the wrapper between two events, which is the host's rate."""
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels import _build
    from ccst_tpu_torch.kernels.adain import (
        fused_adain,
        fused_adain_multi,
        fused_adain_multi_reference,
        fused_adain_reference,
        plan_adain,
    )
    from ccst_tpu_torch.kernels.moments import channel_moments, channel_moments_reference

    lib = _build.library()

    def device_ms(fn, reps):
        return graph_ms(torch, fn, reps, 5)["median"]

    def empty_launch():  # the stream is read at every call: a graph is captured on its own
        if lib.ccst_empty_launch(torch.cuda.current_stream(dev).cuda_stream):
            fail("the empty kernel did not launch")

    empty_ms = device_ms(empty_launch, SMALL_REPS)
    empty_call_ms = time_ms(torch, empty_launch, reps=SMALL_REPS)
    print(f"empty kernel through the same ctypes route: {empty_ms:.4f} ms on the device (CUDA "
          f"graph of {SMALL_REPS}), {empty_call_ms:.4f} ms a call from the host: the floors "
          f"under K4's and K5's times")

    path_shape = relu4_1_shape(batch)
    k4_cases = [(path_shape, t, alpha) for t in ("bfloat16", "float32") for alpha in (1.0, 0.6)]
    for shape, dtype_name, alpha in dict.fromkeys(k4_cases + K4_CASES):
        dtype = getattr(torch, dtype_name)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        feat = (torch.randn(shape, generator=gen) * 2 + 1).to(dev, dtype)
        s_means = torch.randn((3, shape[-1]), generator=gen).to(dev)
        s_stds = (torch.rand((3, shape[-1]), generator=gen) + 0.1).to(dev)
        plan = plan_adain(shape[1] * shape[2])
        variant = "resident" if plan.resident else "streamed"
        single_ms = None
        for s in (1, 3):
            kernel = lambda: fused_adain_multi(feat, s_means[:s], s_stds[:s], alpha)
            plain = lambda: fused_adain_multi_reference(feat, s_means[:s], s_stds[:s], alpha)
            got = kernel()
            torch.cuda.synchronize()
            label = f"{shape} {dtype} alpha={alpha}" + (f" S={s}" if s > 1 else "")
            mx, mean = check_close(f"K4 {label}", got, plain(), **tol)
            if s == 1:  # the single-style wrapper is the S = 1 case of the same kernel
                check_equal(torch, f"K4 fused_adain {label}",
                            fused_adain(feat, s_means[0], s_stds[0], alpha), got[0])
            ms, call_ms = device_ms(kernel, 50), time_ms(torch, kernel, reps=50)
            plain_ms = time_ms(torch, plain, reps=5, runs=3)
            # a few float32 operations an element and style; the tensor in once, out s times
            bd = bound((4 + 6 * s) * feat.numel(), F32_PEAK_TFLOPS,
                       (1 + s) * feat.numel() * feat.element_size())
            row = dict(shape=list(shape), dtype=str(dtype), alpha=alpha, styles=s, kernel_variant=variant,
                       cluster=plan.cluster, max_abs_err=mx, mean_abs_err=mean, ms=ms,
                       call_ms=call_ms, plain_ms=plain_ms, empty_launch_ms=empty_ms, **bd)
            line = (f"K4 adain {label}: max {mx:.3e} mean {mean:.3e} ({variant}, cluster of "
                    f"{plan.cluster}) | kernel {ms:.4f} ms on the device, {call_ms:.4f} ms a call; "
                    f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({100 * bd['bound_ms'] / ms:.1f}% reached; empty launch "
                    f"{100 * empty_ms / ms:.1f}% of it) plain {plain_ms:.4f} ms")
            if s == 1:
                single_ms = ms
            else:  # what S launches of the single-style kernel cost, as the path ran before
                row["single_launches_ms"] = s * single_ms
                line += f" {s} single-style launches {s * single_ms:.4f} ms"
            results["K4"].append(row)
            print(line)
        del feat, got

    k5_cases = [(path_shape, "bfloat16"), (path_shape, "float32")]
    for shape, dtype_name in dict.fromkeys(k5_cases + K5_CASES):
        dtype = getattr(torch, dtype_name)
        feat = (torch.randn(shape, generator=gen) * 3 + 10).to(dev, dtype)
        mean, m2, count = channel_moments(feat)
        torch.cuda.synchronize()
        r_mean, r_m2, r_count = channel_moments_reference(feat)
        if count.item() != r_count.item():
            fail(f"K5 {shape}: count {count.item()} != {r_count.item()}")
        mx1, av1 = check_close(f"K5 mean {shape} {dtype}", mean, r_mean, rtol=1e-5, atol=0.0)
        mx2, av2 = check_close(f"K5 m2 {shape} {dtype}", m2, r_m2, rtol=1e-4, atol=0.0)
        # a second and third launch: the ticket was reset, and no sum depends on
        # which block merged, so the bits are the same
        for run in (2, 3):
            for name, a, b in zip(("mean", "m2", "count"), channel_moments(feat), (mean, m2, count)):
                check_equal(torch, f"K5 {name} {shape} {dtype}, run {run} against run 1", a, b)
        ms = device_ms(lambda: channel_moments(feat), SMALL_REPS)
        call_ms = time_ms(torch, lambda: channel_moments(feat), reps=SMALL_REPS)
        plain = time_ms(torch, lambda: channel_moments_reference(feat), reps=20, runs=3)
        # one read of the tensor, a few float32 operations an element
        bd = bound(6 * feat.numel(), F32_PEAK_TFLOPS, feat.numel() * feat.element_size())
        results["K5"].append(dict(shape=list(shape), dtype=str(dtype), max_abs_err=max(mx1, mx2),
                                  mean_max_abs_err=mx1, m2_max_abs_err=mx2, ms=ms, call_ms=call_ms,
                                  plain_ms=plain, empty_launch_ms=empty_ms, **bd))
        print(f"K5 moments {shape} {dtype}: mean max {mx1:.3e} avg {av1:.3e}, "
              f"m2 max {mx2:.3e} avg {av2:.3e}, three runs the same bits "
              f"| kernel {ms:.4f} ms on the device (CUDA graph of {SMALL_REPS} launches), "
              f"{call_ms:.4f} ms a call; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
              f"({100 * bd['bound_ms'] / ms:.1f}% reached; empty launch "
              f"{100 * empty_ms / ms:.1f}% of it) plain {plain:.4f} ms")

    # ragged edges, correctness only: channels off the 128-byte group, one
    # pixel (K5 only: its variance is 0 / max(1 - ddof, 1)), bf16 rows that are
    # not 16-byte aligned (C = 500 and 100), two banks, the population variance
    for shape, dtype in (((2, 7, 9, 100), torch.float32), ((1, 1, 1, 16), torch.float32),
                         ((2, 5, 11, 500), torch.bfloat16), ((1, 33, 35, 100), torch.bfloat16)):
        feat = (torch.randn(shape, generator=gen) + 3).to(dev, dtype)
        s_means = torch.randn((2, shape[-1]), generator=gen).to(dev)
        s_stds = (torch.rand((2, shape[-1]), generator=gen) + 0.5).to(dev)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        if shape[1] * shape[2] > 1:
            check_close(f"K4 edge {shape}", fused_adain(feat, s_means[0], s_stds[0], 0.6),
                        fused_adain_reference(feat, s_means[0], s_stds[0], 0.6), **tol)
            check_close(f"K4 edge {shape} S=2 ddof=0",
                        fused_adain_multi(feat, s_means, s_stds, 0.6, ddof=0),
                        fused_adain_multi_reference(feat, s_means, s_stds, 0.6, ddof=0), **tol)
        for got, want in zip(channel_moments(feat), channel_moments_reference(feat)):
            check_close(f"K5 edge {shape}", got, want, rtol=1e-4, atol=1e-5)
    torch.cuda.synchronize()
    print("edge shapes: K4, K5 agree with their plain versions")


def int8_layer(torch, gen, cin, cout, requant, dev):
    """Seeded random int8 weights and epilogue terms that spread y over about
    +-100, as a QConvS on ``dev``."""
    from ccst_tpu_torch.kernels.qconv import make_qconv

    wq = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, dtype=torch.int8)
    acc_std = 127 * 73 * math.sqrt(9 * cin)
    k = (torch.rand((cout,), generator=gen) + 0.5) * 40 / acc_std
    kb = torch.randn((cout,), generator=gen) * 10
    return make_qconv(wq.numpy(), k.numpy(), kb.numpy(), False, requant, dev)


def int8_input(torch, gen, shape, dev):
    """Seeded int8 in [-127, 127], drawn where ``gen`` lives."""
    x = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8, device=gen.device)
    return x.to(dev)


def check_int8_kernels(torch, dev, gen, results):
    """Phase 3, int8 part: K0, K1, K2 bit for bit against their plain
    versions at the 512 px shapes, with times; then the ragged shapes."""
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels.level1 import (
        decoder_level1,
        decoder_level1_reference,
        encoder_level1,
        encoder_level1_reference,
        prepare_decoder_level1,
        prepare_encoder_level1,
    )
    from ccst_tpu_torch.kernels.qconv import qconv3x3_s8, qconv3x3_s8_reference

    def k0_pair(x, q, relu, pad):
        kernel = lambda: qconv3x3_s8(x, q, relu, torch.bfloat16, pad)
        plain = lambda: qconv3x3_s8_reference(x, q.wq, q.k, q.kb, relu, q.requant,
                                              torch.bfloat16, pad)
        return kernel, plain

    for layer, (n, h, w, cin, cout), pad, requant, relu in K0_SHAPES:
        x = int8_input(torch, gen, (n, h, w, cin), dev)
        q = int8_layer(torch, gen, cin, cout, requant, dev)
        kernel, plain = k0_pair(x, q, relu, pad)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        check_equal(torch, f"K0 {layer} {(n, h, w, cin, cout)}", got, want)
        if requant and len(torch.unique(got)) < 20:
            fail(f"K0 {layer}: outputs do not spread, the comparison would say little")
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, reps=2, runs=3)
        tops = 2 * n * h * w * 9 * cin * cout / (ms * 1e-3) / 1e12
        bd = conv_bound((n, h, w, cin, cout), INT8_PEAK_TOPS, 1, 1 if requant else 2)
        row = dict(layer=layer, shape=[n, h, w, cin, cout], pad=pad, requant=requant, relu=relu,
                   max_abs_err=0.0, ms=ms, plain_ms=plain_ms, tops=tops,
                   peak_share=tops / INT8_PEAK_TOPS, **bd)
        line = (f"K0 qconv {layer} {(n, h, w, cin, cout)} {pad} "
                f"{'requant' if requant else 'dequant bf16'} relu={relu}: bit-exact "
                f"| kernel {ms:.4f} ms ({tops:.1f} TOPS, {100 * tops / INT8_PEAK_TOPS:.1f}% "
                f"of {INT8_PEAK_TOPS:.0f}) bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                f"({100 * bd['bound_ms'] / ms:.1f}% reached) plain f64 {plain_ms:.4f} ms")
        if ms < GRAPH_BELOW_MS:
            row["graph_ms"] = graph_ms(torch, kernel, 20, 5)["median"]
            line += f"; graph {row['graph_ms']:.4f} ms"
        results["K0"].append(row)
        print(line)

    for (n, h, w, cin, cout), pad, requant, relu in K0_EDGE:
        x = int8_input(torch, gen, (n, h, w, cin), dev)
        q = int8_layer(torch, gen, cin, cout, requant, dev)
        kernel, plain = k0_pair(x, q, relu, pad)
        got = kernel()
        torch.cuda.synchronize()
        check_equal(torch, f"K0 edge {(n, h, w, cin, cout)} {pad}", got, plain())

    for tag, (n, hb, wb) in (("main", (4, 256, 256)), *(("edge", s) for s in LEVEL1_EDGE)):
        c1, c2 = int8_layer(torch, gen, 12, 256, True, dev), int8_layer(torch, gen, 256, 256, True, dev)
        x = int8_input(torch, gen, (n, hb, wb, 12), dev)
        lw = prepare_encoder_level1(c1, c2)  # packed once, as the engine keeps it
        got = encoder_level1(x, c1, c2, lw)
        torch.cuda.synchronize()
        check_equal(torch, f"K1 {tag} {(n, hb, wb, 12)}", got, encoder_level1_reference(x, c1, c2))
        d2, d1 = int8_layer(torch, gen, 64, 256, True, dev), int8_layer(torch, gen, 256, 12, False, dev)
        y = int8_input(torch, gen, (n, hb, wb, 64), dev)
        dw = prepare_decoder_level1(d2, d1)  # packed once, as the decoder's prep keeps it
        got2 = decoder_level1(y, d2, d1, torch.bfloat16, dw)
        torch.cuda.synchronize()
        check_equal(torch, f"K2 {tag} {(n, hb, wb, 64)}", got2,
                    decoder_level1_reference(y, d2, d1, torch.bfloat16))
        if tag != "main":
            continue
        if len(torch.unique(got)) < 20:
            fail("K1: outputs do not spread, the comparison would say little")
        # per packed pixel: the chain's MACs, the bytes in and out, the weights' bytes
        k1_macs, k2_macs = 108 * 256 + 2304 * 256, 576 * 256 + 2304 * 12
        ms = time_ms(torch, lambda: encoder_level1(x, c1, c2, lw))
        plain_ms = time_ms(torch, lambda: encoder_level1_reference(x, c1, c2), reps=2, runs=3)
        tops = 2 * n * hb * wb * k1_macs / (ms * 1e-3) / 1e12
        bd = bound(2 * n * hb * wb * k1_macs, INT8_PEAK_TOPS, n * hb * wb * (12 + 64) + k1_macs)
        results["K1"].append(dict(shape=[n, hb, wb, 12], max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                  tops=tops, **bd))
        print(f"K1 level1 {(n, hb, wb)} packed: bit-exact | kernel {ms:.4f} ms "
              f"({tops:.1f} TOPS of the unfused chain's MACs) bound {bd['bound_ms']:.4f} ms by "
              f"{bd['bound_by']} ({100 * bd['bound_ms'] / ms:.1f}% reached) "
              f"plain f64 chain {plain_ms:.4f} ms")
        del x, got

        # K2 and the two K0 launches it replaces in int8-fused (folded dconv1_2 with
        # requant, packed dconv1_1 with dequant, the int8 intermediate between
        # them), both on the device from a replayed CUDA graph, at each batch
        def k0_chain(t):
            z = qconv3x3_s8(t, d2, True, torch.bfloat16, "edge")
            return qconv3x3_s8(z, d1, False, torch.bfloat16, "edge")

        for nb in K2_BATCHES:
            yb = y if nb == n else int8_input(torch, gen, (nb, hb, wb, 64), dev)
            kernel = lambda: decoder_level1(yb, d2, d1, torch.bfloat16, dw)
            if nb != n:
                got_b = kernel()
                check_equal(torch, f"K2 {(nb, hb, wb, 64)} vs the K0 chain", got_b, k0_chain(yb))
                # the K0 chain is a kernel too: the last images also against the plain version
                check_equal(torch, f"K2 {(nb, hb, wb, 64)} images {nb - n}..{nb - 1}", got_b[nb - n:],
                            decoder_level1_reference(yb[nb - n:], d2, d1, torch.bfloat16))
                del got_b
            reps, runs = (20, 5) if nb <= 4 else (5, 3)
            ms = graph_ms(torch, kernel, reps, runs)["median"]
            chain_ms = graph_ms(torch, lambda: k0_chain(yb), reps, runs)["median"]
            row = dict(shape=[nb, hb, wb, 64], max_abs_err=0.0, ms=ms, replaces_chain_ms=chain_ms,
                       library_ms=None,
                       **bound(2 * nb * hb * wb * k2_macs, INT8_PEAK_TOPS,
                               nb * hb * wb * (64 + 2 * 12) + k2_macs))
            row["tops"] = 2 * nb * hb * wb * k2_macs / (ms * 1e-3) / 1e12
            line = ""
            if nb == n:
                row["call_ms"] = time_ms(torch, kernel)
                row["plain_ms"] = time_ms(
                    torch, lambda: decoder_level1_reference(y, d2, d1, torch.bfloat16), reps=2, runs=3)
                line = (f", {row['call_ms']:.4f} ms a call from the host; plain f64 chain "
                        f"{row['plain_ms']:.4f} ms")
            results["K2"].append(row)
            print(f"K2 level1 {(nb, hb, wb)} packed: bit-exact | kernel {ms:.4f} ms on the device "
                  f"(CUDA graph of {reps}; {row['tops']:.1f} TOPS of the unfused chain's MACs) bound "
                  f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                  f"({100 * row['bound_ms'] / ms:.1f}% reached); the two K0 launches it "
                  f"replaces {chain_ms:.4f} ms (K2 is {chain_ms / ms:.2f}x)" + line)
            del yb
    torch.cuda.synchronize()
    print("edge shapes: K0, K1, K2 equal their plain versions")


def check_ab_kernels(torch, dev, cpu_gen, results):
    """Phase 3, A/B part: B1, B2 (direct, Winograd in its three modes) and B3
    (F9, F3) bit for bit against their plain versions at the harnesses'
    full-width shapes, with times; then ragged shapes."""
    import numpy as np

    from ccst_tpu_torch import benchmarks as bm
    from ccst_tpu_torch.benchmarks.int8_mm import VARIANTS
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels import winograd as wg
    from ccst_tpu_torch.kernels.int8_mm import prepare_mm_weight, tiled_mm, tiled_mm_reference
    from ccst_tpu_torch.kernels.level1 import phase_max
    from ccst_tpu_torch.kernels.pool_conv import (
        pool_conv_fused,
        pool_conv_reference,
        prepare_pool_conv,
    )
    from ccst_tpu_torch.kernels.qconv import qconv3x3_s8

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)  # the big inputs are drawn on the card
    for m, k, n in [*((B1_M, k, n) for k, n in B1_SHAPES), *B1_EDGE]:
        xi = int8_input(torch, gen, (m, k), dev)
        wi = int8_input(torch, gen, (k, n), dev)
        for name, in_dtype, out_dtype in VARIANTS:
            x, w = xi.to(in_dtype), wi.to(in_dtype)
            mw = prepare_mm_weight(w)
            got = tiled_mm(x, mw, out_dtype)
            torch.cuda.synchronize()
            check_equal(torch, f"B1 {name} {(m, k, n)}", got, tiled_mm_reference(x, w, out_dtype))
            if m != B1_M:
                continue
            ms = time_ms(torch, lambda: tiled_mm(x, mw, out_dtype))
            plain_ms = time_ms(torch, lambda: tiled_mm_reference(x, w, out_dtype), reps=2, runs=3)
            tops = 2 * m * k * n / (ms * 1e-3) / 1e12
            peak = bm.BF16_PEAK_TFLOPS if name == "bf16" else bm.INT8_PEAK_TOPS
            row = dict(shape=[m, k, n], variant=name, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       tops=tops, peak_share=tops / peak,
                       **bound(2 * m * k * n, peak, (m * k + k * n) * x.element_size() + 4 * m * n))
            line = (f"B1 tiled_mm {name} {(m, k, n)}: bit-exact | kernel {ms:.4f} ms "
                    f"({tops:.1f} TOPS, {100 * row['peak_share']:.1f}% of peak) bound "
                    f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                    f"({100 * row['bound_ms'] / ms:.1f}% reached) plain f64 {plain_ms:.4f} ms")
            # the library's call for the same function, for comparison only: not the port
            if name == "i8i32":
                row["library_ms"] = time_ms(torch, lambda: torch._int_mm(x, w))
                line += f" torch._int_mm {row['library_ms']:.4f} ms"
            elif name == "bf16":
                row["library_ms"] = time_ms(torch, lambda: torch.mm(x, w, out_dtype=torch.float32))
                # writes bf16, half the kernel's output bytes: not the same function
                row["cublas_bf16_out_ms"] = time_ms(torch, lambda: torch.matmul(x, w))
                line += (f" torch.mm f32 out {row['library_ms']:.4f} ms "
                         f"(bf16 out {row['cublas_bf16_out_ms']:.4f} ms)")
            results["B1"].append(row)
            print(line)

    for (n, h, w, cin, cout) in (B2_MAIN, *B2_EDGE):
        x = int8_input(torch, gen, (n, h, w, cin), dev)
        wq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
        uq, _ = wg.wino_weights(wq)
        k_dir = (rng.uniform(0.5, 1.5, cout) * 40 / (127 * 73 * math.sqrt(9 * cin))).astype(np.float32)
        k_wino = (rng.uniform(0.5, 1.5, cout) * 40 / (127 * 73 * math.sqrt(16 * cin))).astype(np.float32)
        kb = (rng.standard_normal(cout) * 10 + 40).astype(np.float32)
        c = wg.make_wino_conv(wq, uq, k_dir, k_wino, kb, dev)
        cases = [("B2-direct", "direct", lambda: wg.conv_direct(x, c),
                  lambda: wg.conv_direct_reference(x, c))]
        cases += [("B2-wino", mode, lambda m=mode: wg.conv_wino(x, c, m),
                   lambda m=mode: wg.conv_wino_reference(x, c, m))
                  for mode in wg.MODES if mode != "tf" or cout <= cin]
        main = (n, h, w, cin, cout) == B2_MAIN
        if main:  # the production conv at the same shape: the A/B's yardstick
            k0_ms = graph_ms(torch, lambda: qconv3x3_s8(x, c.direct, True, torch.int8, "edge"),
                             10, 5)["median"]
        for kid, mode, kernel, plain in cases:
            got = kernel()
            torch.cuda.synchronize()
            check_equal(torch, f"{kid} {mode} {(n, h, w, cin, cout)}", got, plain())
            if not main:
                continue
            if mode in ("direct", "full") and len(torch.unique(got)) < 20:
                fail(f"{kid} {mode}: outputs do not spread, the comparison would say little")
            ms = graph_ms(torch, kernel, 10, 5)["median"]
            plain_ms = time_ms(torch, plain, reps=2, runs=3)
            tops = 2 * n * h * w * 9 * cin * cout / (ms * 1e-3) / 1e12
            results[kid].append(dict(shape=[n, h, w, cin, cout], mode=mode, max_abs_err=0.0,
                                     ms=ms, plain_ms=plain_ms, tops=tops, k0_ms=k0_ms))
            # Winograd F(2x2, 3x3) multiplies 16 positions per 2 x 2 outputs, not 36
            bd = conv_bound((n, h, w, cin, cout), INT8_PEAK_TOPS, 1, 1)
            if kid == "B2-wino":
                bd = bound(2 * n * h * w * 4 * cin * cout, INT8_PEAK_TOPS,
                           n * h * w * (cin + cout) + 16 * cin * cout)
            results[kid][-1].update(bd)
            print(f"{kid} {mode} {(n, h, w, cin, cout)}: bit-exact | kernel {ms:.4f} ms on the "
                  f"device (CUDA graph of 10; {tops:.1f} direct-conv TOPS) bound "
                  f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                  f"({100 * bd['bound_ms'] / ms:.1f}% reached); K0 at the same shape {k0_ms:.4f} "
                  f"ms ({k0_ms / ms:.2f}x the kernel); plain f64 {plain_ms:.4f} ms")

    for (n, hb, wb) in (B3_MAIN, *B3_EDGE):
        xp = torch.randint(-5, 120, (n, hb, wb, 256), generator=gen, dtype=torch.int8, device=dev)
        q = int8_layer(torch, cpu_gen, 64, 128, True, dev)
        wp = prepare_pool_conv(q)  # packed once, as the harness keeps it
        plain = lambda: torch.cat([pool_conv_reference(xp[i:i + 16], q) for i in range(0, n, 16)])
        want = plain()
        if (n, hb, wb) == B3_MAIN:  # the unfused chain the fused kernel stands against
            chain = lambda: qconv3x3_s8(phase_max(xp, 64), q, True, torch.int8, "reflect")
            check_equal(torch, f"B3 unfused chain {(n, hb, wb, 256)}", chain(), want)
            chain_ms = time_ms(torch, chain, reps=5, runs=3)
        for tag, cat in (("F9", False), ("F3", True)):
            got = pool_conv_fused(xp, q, cat, wp)
            torch.cuda.synchronize()
            check_equal(torch, f"B3 {tag} {(n, hb, wb, 256)}", got, want)
            if (n, hb, wb) != B3_MAIN:
                continue
            if len(torch.unique(got)) < 20:
                fail(f"B3 {tag}: outputs do not spread, the comparison would say little")
            ms = time_ms(torch, lambda c=cat: pool_conv_fused(xp, q, c, wp))
            plain_ms = time_ms(torch, plain, reps=1, runs=3)
            tops = 2 * n * hb * wb * 576 * 128 / (ms * 1e-3) / 1e12
            bd = bound(2 * n * hb * wb * 576 * 128, INT8_PEAK_TOPS,
                       n * hb * wb * (256 + 128) + 576 * 128)
            results["B3"].append(dict(shape=[n, hb, wb, 256], variant=tag, cat=cat, max_abs_err=0.0,
                                      ms=ms, plain_ms=plain_ms, tops=tops,
                                      replaces_chain_ms=chain_ms, **bd))
            print(f"B3 pool_conv {tag} {(n, hb, wb, 256)}: bit-exact | kernel {ms:.4f} ms "
                  f"({tops:.1f} TOPS) bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                  f"({100 * bd['bound_ms'] / ms:.1f}% reached); the unfused chain (phase max + K0) "
                  f"{chain_ms:.4f} ms ({chain_ms / ms:.2f}x); plain (phase max + f64 conv) "
                  f"{plain_ms:.4f} ms")
        del want
    for (n, hb, wb, cout) in B3_EDGE_COUT:
        xp = torch.randint(-5, 120, (n, hb, wb, 256), generator=gen, dtype=torch.int8, device=dev)
        q = int8_layer(torch, cpu_gen, 64, cout, True, dev)
        want = pool_conv_reference(xp, q)
        for tag, cat in (("F9", False), ("F3", True)):
            got = pool_conv_fused(xp, q, cat)
            torch.cuda.synchronize()
            check_equal(torch, f"B3 {tag} {(n, hb, wb, 256)} -> Cout {cout}", got, want)
    torch.cuda.synchronize()
    print("edge shapes: B1, B2, B3 (every output-channel tile) equal their plain versions")


def run_harnesses(torch, counters):
    """Phase 6: the three int8 A/B harnesses in this process, each with every
    launch count zeroed before it and read after it; the counts must be the
    ones its arguments imply. Returns the B kernels' counts."""
    from ccst_tpu_torch.benchmarks import fused_pool_conv_ab, int8_mm, winograd_ab

    ids = {"tiled_mm": "B1", "conv_direct": "B2-direct", "conv_wino": "B2-wino",
           "pool_conv_fused": "B3", "qconv3x3_s8": "K0"}
    launches = {}
    for mod, argv in ((int8_mm, HARNESS_REPS), (winograd_ab, HARNESS_REPS),
                      (fused_pool_conv_ab, ["--batch", str(B3_HARNESS_BATCH), *HARNESS_REPS])):
        name = mod.__name__.rsplit(".", 1)[1]
        expect = {k: 0 for k in counters}
        expect.update({ids[fn]: count for fn, count in mod.planned_launches(mod.parse_args(argv)).items()})
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        mod.main(argv)
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counters.items()}
        if got != expect:
            fail(f"harness {name}: kernel launches {got}, expected {expect}")
        print(f"harness {name} ({time.perf_counter() - t0:.1f} s): kernel launches "
              f"{ {k: v for k, v in got.items() if v} } (as expected)")
        for k, v in got.items():
            if k.startswith("B"):
                launches[k] = launches.get(k, 0) + v
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images-per-domain", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    args = ap.parse_args()
    images_per_domain, batch = args.images_per_domain, args.batch_size
    if images_per_domain < batch:
        raise SystemExit("chip_smoke: --images-per-domain must be at least --batch-size")

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ccst_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels import _build
    from ccst_tpu_torch.kernels.adain import (
        fused_adain,
        fused_adain_multi,
        fused_adain_reference,
    )
    from ccst_tpu_torch.kernels.int8_mm import tiled_mm
    from ccst_tpu_torch.kernels.pool_conv import pool_conv_fused
    from ccst_tpu_torch.kernels.winograd import conv_direct, conv_wino
    from ccst_tpu_torch.kernels.conv import (
        prepare_conv,
        reflect_conv3x3,
        reflect_conv3x3_reference,
    )
    from ccst_tpu_torch.kernels.level1 import (
        decoder_level1,
        encoder_level1,
        encoder_level1_reference,
    )
    from ccst_tpu_torch.kernels.moments import channel_moments
    from ccst_tpu_torch.kernels.qconv import qconv3x3_s8, qconv3x3_s8_reference

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, "
          f"{'reused' if cached else 'compiled'} {_build.library_path().name})")

    # -- 3. kernels vs plain versions --------------------------------------
    gen = torch.Generator().manual_seed(0)
    results = {k: [] for k in ("K3", "K4", "K5", "K0", "K1", "K2", "B1", "B2-direct",
                               "B2-wino", "B3")}

    for layer, (n, h, w, cin, cout) in K3_SHAPES:
        x = torch.randn((n, h, w, cin), generator=gen).to(dev, torch.bfloat16)
        spread = (1.0 / (9 * cin)) ** 0.5
        wt = (torch.rand((3, 3, cin, cout), generator=gen) * 2 - 1) * spread
        b = (torch.rand((cout,), generator=gen) * 2 - 1) * spread
        cw = prepare_conv(wt, b, torch.bfloat16, dev)
        bd = conv_bound((n, h, w, cin, cout), BF16_PEAK_TFLOPS, 2, 2)
        flop = 2 * n * h * w * 9 * cin * cout
        for relu in (True, False):
            got = reflect_conv3x3(x, cw, relu)
            torch.cuda.synchronize()
            want = reflect_conv3x3_reference(x, cw.w, cw.b, relu)
            mx, mean = check_close(f"K3 {(n, h, w, cin, cout)} relu={relu}", got, want, **BF16_TOL)
            row = dict(layer=layer, shape=[n, h, w, cin, cout], relu=relu, max_abs_err=mx,
                       mean_abs_err=mean)
            if relu:  # timed once a shape; ReLU is one max in the epilogue
                ms = time_ms(torch, lambda: reflect_conv3x3(x, cw, True))
                plain = time_ms(torch, lambda: reflect_conv3x3_reference(x, cw.w, cw.b, True),
                                reps=3, runs=3)
                torch.backends.cudnn.benchmark = True
                lib = time_ms(torch, cudnn_bf16_conv(torch, x, cw))
                torch.backends.cudnn.benchmark = False
                row.update(ms=ms, plain_ms=plain, cudnn_bf16_ms=lib, **bd)
                line = (f"K3 conv {layer} {(n, h, w, cin, cout)}: max {mx:.3e} mean {mean:.3e} "
                        f"| kernel {ms:.4f} ms ({flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s) bound "
                        f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                        f"({100 * bd['bound_ms'] / ms:.1f}% reached) cuDNN bf16 {lib:.4f} ms "
                        f"({flop / (lib * 1e-3) / 1e12:.1f} TFLOP/s) plain f32 {plain:.4f} ms")
                if ms < GRAPH_BELOW_MS:
                    row["graph_ms"] = graph_ms(torch, lambda: reflect_conv3x3(x, cw, True), 20,
                                               5)["median"]
                    line += f"; graph {row['graph_ms']:.4f} ms"
                print(line)
            else:
                print(f"K3 conv {layer} {(n, h, w, cin, cout)} relu=False: max {mx:.3e} mean {mean:.3e}")
            results["K3"].append(row)

    # K3's exact float32 route (the engines' --dtype float32): FFMA sums, TF32
    # off on both sides, cuDNN's float32 conv timed beside it for comparison only
    for layer, (n, h, w, cin, cout) in K3_F32_SHAPES:
        x = torch.randn((n, h, w, cin), generator=gen).to(dev)
        spread = (1.0 / (9 * cin)) ** 0.5
        wt = (torch.rand((3, 3, cin, cout), generator=gen) * 2 - 1) * spread
        b = (torch.rand((cout,), generator=gen) * 2 - 1) * spread
        cw = prepare_conv(wt, b, torch.float32, dev)
        bd = conv_bound((n, h, w, cin, cout), F32_PEAK_TFLOPS, 4, 4)
        flop = 2 * n * h * w * 9 * cin * cout
        for relu in (True, False):
            got = reflect_conv3x3(x, cw, relu)
            torch.cuda.synchronize()
            want = reflect_conv3x3_reference(x, cw.w, cw.b, relu)
            mx, mean = check_close(f"K3 float32 {(n, h, w, cin, cout)} relu={relu}", got, want,
                                   **K3_F32_TOL)
            row = dict(layer=layer, shape=[n, h, w, cin, cout], relu=relu, dtype="torch.float32",
                       max_abs_err=mx, mean_abs_err=mean)
            if relu:  # every shape timed once, cuDNN's float32 conv (TF32 off) beside it
                ms = time_ms(torch, lambda: reflect_conv3x3(x, cw, True), reps=3, runs=3)
                plain = time_ms(torch, lambda: reflect_conv3x3_reference(x, cw.w, cw.b, True),
                                reps=2, runs=3)
                lib = time_ms(torch, cudnn_bf16_conv(torch, x, cw), reps=2, runs=3)
                row.update(ms=ms, plain_ms=plain, cudnn_f32_ms=lib, **bd)
                line = (f"K3 conv float32 {layer} {(n, h, w, cin, cout)}: max {mx:.3e} mean "
                        f"{mean:.3e} | kernel {ms:.4f} ms ({flop / (ms * 1e-3) / 1e12:.2f} TFLOP/s) "
                        f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                        f"({100 * bd['bound_ms'] / ms:.1f}% reached) cuDNN float32, TF32 off "
                        f"{lib:.4f} ms ({lib / ms:.2f}x the kernel) plain {plain:.4f} ms")
                if ms < GRAPH_BELOW_MS:
                    row["graph_ms"] = graph_ms(torch, lambda: reflect_conv3x3(x, cw, True), 20,
                                               5)["median"]
                    line += f"; graph {row['graph_ms']:.4f} ms"
                print(line)
            else:
                print(f"K3 conv float32 {layer} {(n, h, w, cin, cout)} relu={relu}: "
                      f"max {mx:.3e} mean {mean:.3e}")
            results["K3"].append(row)
    del x, got, want

    check_small_kernels(torch, dev, gen, results, batch)

    # ragged edges, correctness only: the smallest reflectable plane (below the
    # 8 x 16 tile), planes that are no multiple of it with Cout = 3 and N > 1,
    # the scalar Cin = 3 gather, two rows, Cin ending inside a 64-channel chunk
    # with Cout off the 8-channel store, Cout over two 128-wide tiles
    for (n, h, w, cin, cout) in ((1, 2, 2, 64, 64), (3, 17, 9, 128, 3), (1, 5, 3, 3, 64),
                                 (2, 2, 19, 64, 64), (1, 9, 20, 80, 12), (2, 11, 33, 16, 136)):
        x = torch.randn((n, h, w, cin), generator=gen).to(dev, torch.bfloat16)
        cw = prepare_conv(torch.randn((3, 3, cin, cout), generator=gen) * 0.1,
                          torch.randn((cout,), generator=gen), torch.bfloat16, dev)
        got = reflect_conv3x3(x, cw, True)
        torch.cuda.synchronize()
        check_close(f"K3 edge {(n, h, w, cin, cout)}", got,
                    reflect_conv3x3_reference(x, cw.w, cw.b, True), **BF16_TOL)
    torch.cuda.synchronize()
    print("edge shapes: K3 agrees with its plain version")

    check_int8_kernels(torch, dev, gen, results)
    check_ab_kernels(torch, dev, gen, results)

    # -- 4. the main paths through the CLI ---------------------------------
    import numpy as np

    from ccst_tpu_torch import cli
    from ccst_tpu_torch.models import convert, vgg, vgg_fast
    from ccst_tpu_torch.pipeline.style_bank import load_style_stats
    from ccst_tpu_torch.pipeline.stylize import StylizeEngine

    counters = {"K3": reflect_conv3x3, "K4": fused_adain_multi, "K5": channel_moments,
                "K0": qconv3x3_s8, "K1": encoder_level1, "K2": decoder_level1,
                "B1": tiled_mm, "B2-direct": conv_direct, "B2-wino": conv_wino,
                "B3": pool_conv_fused}
    launches = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory(prefix="ccst_smoke_") as root:
        t0 = time.perf_counter()
        write_tree(root, images_per_domain)
        print(f"synthetic tree: {len(DOMAINS)} x {images_per_domain} PNGs at {SIZE} px "
              f"in {time.perf_counter() - t0:.1f} s")
        enc = vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(42))
        dec = vgg.init_params(vgg.DECODER_ARCH, torch.Generator().manual_seed(43))
        last = dec["dconv1_1"]
        last["w"], last["b"] = last["w"] * DEC_SCALE, last["b"] * DEC_SCALE + DEC_SHIFT
        enc_path = os.path.join(root, "vgg.npz")
        dec_path = os.path.join(root, "decoder.npz")
        convert.save_npz(enc_path, enc)
        convert.save_npz(dec_path, dec)
        stats_dir = os.path.join(root, "style_stats")
        int8_root = os.path.join(root, "int8")
        f32_root = os.path.join(root, "float32")  # the parity mode's banks and outputs
        f32_stats = os.path.join(f32_root, "style_stats")

        def common(out_root, dtype="bfloat16", stats=stats_dir):
            return [
                "--dataset", "pacs", "--list-root", root, "--data-root", root,
                "--output-root", out_root, "--style-stats-dir", stats,
                "--image-size", str(SIZE), "--batch-size", str(batch), "--dtype", dtype,
                "--vgg-weights", enc_path, "--decoder-weights", dec_path, "--device", "cuda",
            ]

        n_bank_batches = len(DOMAINS) * -(-images_per_domain // batch)
        n_styles = len(DOMAINS) - 1
        n_content_batches = -(-images_per_domain // batch)
        target = ["--target", "photo"]
        steps = (
            ("style-bank", ["style-bank", *common(root)],
             {"K3": 9 * n_bank_batches, "K5": n_bank_batches}),
            ("stylize ref", ["stylize", *common(root), *target, "--mode", "overall"],
             {"K3": (9 + 9 * n_styles) * n_content_batches, "K4": n_content_batches}),
            ("calibrate", ["calibrate", *common(root), *target, "--engine", "int8-fused"], {}),
            ("stylize int8-fused", ["stylize", *common(int8_root), *target, "--mode", "overall",
                                    "--engine", "int8-fused"],
             {"K0": (7 + 7 * n_styles) * n_content_batches, "K1": n_content_batches,
              "K2": n_styles * n_content_batches, "K4": n_content_batches}),
            ("style-bank float32", ["style-bank", *common(f32_root, "float32", f32_stats)],
             {"K3": 9 * n_bank_batches, "K5": n_bank_batches}),
            ("stylize ref float32", ["stylize", *common(f32_root, "float32", f32_stats), *target,
                                     "--mode", "overall"],
             {"K3": (9 + 9 * n_styles) * n_content_batches, "K4": n_content_batches}),
        )
        for step, argv, expect in steps:
            expect = {k: expect.get(k, 0) for k in counters}
            for fn in counters.values():
                fn.launches = 0
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            got = {k: fn.launches for k, fn in counters.items()}
            print(out.getvalue(), end="")
            if rc != 0:
                fail(f"{step} returned {rc}")
            if got != expect:
                fail(f"{step}: kernel launches {got}, expected {expect}")
            print(f"{step}: kernel launches {got} (as expected)")
            if step == "stylize int8-fused" and "loading int8 calibration" not in out.getvalue():
                fail("stylize int8-fused did not load the calibration that calibrate wrote")
            for k in counters:
                launches[k] += got[k]
        for k in ("K0", "K1", "K2", "K3", "K4", "K5"):
            if launches[k] == 0:
                fail(f"{k} was never launched on the main paths")

        for d in DOMAINS:
            mean, std = load_style_stats(os.path.join(stats_dir, "pacs", f"{d}_mean_std.npz"))
            mean32, std32 = load_style_stats(os.path.join(f32_stats, "pacs", f"{d}_mean_std.npz"))
            for m, sd in ((mean, std), (mean32, std32)):
                if m.shape != (512,) or not (np.isfinite(m).all() and np.isfinite(sd).all()):
                    fail(f"bank {d}: bad shape or non-finite values")
            # the bf16 bank against the float32 one: the same images, bf16 features
            if not np.allclose(mean, mean32, rtol=5e-2, atol=5e-3):
                fail(f"bank {d}: the bfloat16 bank is off the float32 bank by "
                     f"{np.abs(mean - mean32).max():.3e}")
            for tag, sdir in (("bfloat16", stats_dir), ("float32", f32_stats)):
                with open(os.path.join(sdir, "pacs", f"{d}_style_comp_time.json")) as f:
                    t = json.load(f)
                print(f"style-bank {d} {tag}: {t['images']} images in {t['seconds']:.3f} s = "
                      f"{t['images_per_sec']:.1f} img/s at {SIZE} px")
        scales_path = os.path.join(stats_dir, "pacs", "photo_q8_scales.json")
        scales = vgg_fast.load_scales(scales_path,
                                      expect_fingerprint=vgg_fast.weights_fingerprint(enc, dec))
        if len(scales) != 18 or not all(math.isfinite(v) and v > 0 for v in scales.values()):
            fail(f"calibrate wrote bad scales: {scales}")
        print(f"calibrate: {len(scales)} scales, {min(scales.values()):.4g}..{max(scales.values()):.4g}")
        for engine_name, out_root in (("ref", root), ("int8-fused", int8_root),
                                      ("ref float32", f32_root)):
            out_dir = os.path.join(out_root, "PACS", "all_style_transferred_Overall", "photo")
            outputs = [os.path.join(dp, f) for dp, _, fs in os.walk(out_dir) for f in fs]
            if len(outputs) != images_per_domain * n_styles:
                fail(f"stylize {engine_name} wrote {len(outputs)} images, "
                     f"expected {images_per_domain * n_styles}")
            with open(os.path.join(out_root, "pacs_photo_overall_stylize_time.json")) as f:
                timing = json.load(f)
            print(f"stylize {engine_name} timing: " + json.dumps(timing))
            sample = read_images(sorted(outputs)[:batch])
            print(f"stylized PNGs ({engine_name}): u8 range {sample.min()}..{sample.max()}, "
                  f"mean {sample.mean():.1f} over {len(sample)} images")

        # -- 5. whole paths vs plain paths ------------------------------------
        from ccst_tpu_torch.models.vgg import Conv, Pool, Tap, Upsample

        banks = [load_style_stats(os.path.join(stats_dir, "pacs", f"{d}_mean_std.npz"))
                 for d in DOMAINS if d != "photo"]
        s_means = torch.tensor(np.stack([m for m, _ in banks]), device=dev)
        s_stds = torch.tensor(np.stack([s for _, s in banks]), device=dev)
        photo = [os.path.join(root, f"PACS/kfold/photo/dog/img{i}.png") for i in range(batch)]
        images_u8 = torch.from_numpy(read_images(photo))
    images_u8 = images_u8.to(dev)

    engine = StylizeEngine(enc, dec, dtype=torch.bfloat16, device=dev)
    got = engine.stylize_multi(images_u8, s_means, s_stds, 1.0)

    def plain_apply(params, x, arch, stop_at=""):
        for layer in arch:
            if isinstance(layer, Conv):
                cw = params[layer.name]
                if layer.ksize == 3:
                    x = reflect_conv3x3_reference(x, cw.w, cw.b, layer.relu)
                else:
                    x = vgg.conv1x1(x, cw)
            elif isinstance(layer, Pool):
                x = vgg.maxpool_ceil(x)
            elif isinstance(layer, Upsample):
                x = vgg.upsample_nearest2x(x)
            elif isinstance(layer, Tap) and layer.name == stop_at:
                return x
        return x

    with torch.no_grad():
        x = (images_u8.float() / 255.0).to(torch.bfloat16)
        feat = plain_apply(engine.enc, x, vgg.ENCODER_ARCH, stop_at="relu4_1")
        want = torch.stack([
            plain_apply(engine.dec, fused_adain_reference(feat, m, s, 1.0), vgg.DECODER_ARCH).float()
            for m, s in zip(s_means, s_stds)
        ])
    if got.shape != (n_styles, batch, SIZE, SIZE, 3) or not bool(got.isfinite().all()):
        fail(f"stylize_multi: shape {tuple(got.shape)} or non-finite values")
    err = (got - want).abs()
    mae = err.mean().item()
    spread = (want.max() - want.min()).item()
    print(f"ref: whole path vs plain path ({n_styles} styles x {batch} x {SIZE}px bf16): "
          f"MAE {mae:.3e} ({mae / spread:.3e} of the output range) max {err.max().item():.3e}; "
          f"output range {want.min().item():.3f}..{want.max().item():.3f}")
    if not spread >= MIN_SPREAD:
        fail(f"outputs span {spread:.3f} < {MIN_SPREAD}: the MAE bar would say little")
    if not mae <= MAE_BAR:
        fail(f"whole-path MAE {mae:.3e} > {MAE_BAR}")
    ref_out = got

    # the parity mode: the float32 ``ref`` engine (K3's exact float32 route, K4
    # in float32) against the same path composed from the plain versions
    engine32 = StylizeEngine(enc, dec, dtype=torch.float32, device=dev)
    for fn in counters.values():
        fn.launches = 0
    got32 = engine32.stylize_multi(images_u8, s_means, s_stds, 1.0)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
    if counts != {"K3": 9 + 9 * n_styles, "K4": 1}:
        fail(f"float32 ref stylize_multi: launches {counts}, expected K3 {9 + 9 * n_styles}, K4 1")
    with torch.no_grad():
        feat32 = plain_apply(engine32.enc, images_u8.float() / 255.0, vgg.ENCODER_ARCH,
                             stop_at="relu4_1")
        want32 = torch.stack([
            plain_apply(engine32.dec, fused_adain_reference(feat32, m, s, 1.0), vgg.DECODER_ARCH)
            for m, s in zip(s_means, s_stds)
        ])
    if got32.shape != want32.shape or not bool(got32.isfinite().all()):
        fail(f"float32 stylize_multi: shape {tuple(got32.shape)} or non-finite values")
    mae32 = (got32 - want32).abs().mean().item()
    print(f"ref float32: whole path vs plain path: MAE {mae32:.3e} max "
          f"{(got32 - want32).abs().max().item():.3e}; against the bf16 engine MAE "
          f"{(got32 - ref_out).abs().mean().item():.3e}; launches {counts} (as expected)")
    if not mae32 <= F32_MAE_BAR:
        fail(f"float32 whole-path MAE {mae32:.3e} > {F32_MAE_BAR}")
    del got32, want32, feat32

    # int8-fused, from the scales calibrate wrote, against its plain composition
    def plain_q8s(ep, dp, images):
        def qref(x, q, relu, pad):
            return qconv3x3_s8_reference(x, q.wq, q.k, q.kb, relu, q.requant, torch.bfloat16, pad)

        x = vgg.conv1x1((images.float() / 255.0).to(torch.bfloat16), ep["conv0"])
        xq = vgg_fast.pack_s2d(vgg_fast.quantize_static(x, ep["__scales__"]["conv1_1"] / 127.0))
        xq = encoder_level1_reference(xq, ep["conv1_1"], ep["conv1_2"])
        pools = 0
        for layer in vgg.ENCODER_ARCH:
            if isinstance(layer, Conv) and layer.name not in ("conv0", "conv1_1", "conv1_2"):
                xq = qref(xq, ep[layer.name], layer.relu, "reflect")
                if layer.name == "conv4_1":
                    break
            elif isinstance(layer, Pool):
                pools += 1
                if pools > 1:
                    xq = vgg.maxpool_ceil(xq)
        outs = []
        for m, s in zip(s_means, s_stds):
            yq = vgg_fast.quantize_static(fused_adain_reference(xq, m, s, 1.0),
                                          dp["__scales__"]["dconv4_1"] / 127.0)
            for layer in vgg_fast._DEC_MID:
                if isinstance(layer, Conv):
                    yq = qref(yq, dp[layer.name], layer.relu, "reflect")
                elif isinstance(layer, Upsample):
                    yq = vgg.upsample_nearest2x(yq)
            yq = qref(yq, dp["dconv1_2"], True, "edge")
            outs.append(vgg_fast.unpack_d2s(qref(yq, dp["dconv1_1"], False, "edge"), 3).float())
        return torch.stack(outs)

    engines = {name: StylizeEngine(enc, dec, dtype=torch.bfloat16, device=dev, engine=name,
                                   scales=scales)
               for name in ("int8-fused", "int8-static")}
    q8 = {}
    for name, per_batch in (("int8-fused", {"K0": 7 + 7 * n_styles, "K1": 1, "K2": n_styles}),
                            ("int8-static", {"K0": 9 + 9 * n_styles, "K1": 0, "K2": 0})):
        for fn in counters.values():
            fn.launches = 0
        q8[name] = engines[name].stylize_multi(images_u8, s_means, s_stds, 1.0)
        torch.cuda.synchronize()
        counts = {k: counters[k].launches for k in ("K0", "K1", "K2", "K3", "K4")}
        expect = {"K3": 0, "K4": 1, **per_batch}
        if counts != expect:
            fail(f"{name} stylize_multi: launches {counts}, expected {expect}")
        print(f"{name} stylize_multi: launches {counts} per content batch (as expected)")
    fused_out = q8["int8-fused"]
    if fused_out.shape != ref_out.shape or not bool(fused_out.isfinite().all()):
        fail(f"int8-fused: shape {tuple(fused_out.shape)} or non-finite values")
    check_equal(torch, "int8-fused vs int8-static", fused_out, q8["int8-static"])
    print("int8-fused equals int8-static bit for bit")
    ep = vgg_fast.prepare_encoder_q8s(engines["int8-fused"]._enc_w, scales, torch.bfloat16, dev)
    dp = vgg_fast.prepare_decoder_q8s(engines["int8-fused"]._dec_w, scales, torch.bfloat16, dev)
    with torch.no_grad():
        want_q8 = plain_q8s(ep, dp, images_u8)
    err = (fused_out - want_q8).abs()
    mae_q8 = err.mean().item()
    print(f"int8-fused: whole path vs plain path: MAE {mae_q8:.3e} max {err.max().item():.3e}; "
          f"output range {want_q8.min().item():.3f}..{want_q8.max().item():.3f}")
    if not mae_q8 <= MAE_BAR:
        fail(f"int8-fused whole-path MAE {mae_q8:.3e} > {MAE_BAR}")
    mse = ((fused_out - ref_out) ** 2).mean().item()
    psnr = 10 * math.log10(spread ** 2 / mse)
    print(f"int8-fused vs bf16 ref: PSNR {psnr:.2f} dB over the ref's range {spread:.3f} "
          f"(MAE {(fused_out - ref_out).abs().mean().item():.3e})")
    if not psnr > PSNR_BAR:
        fail(f"int8-fused vs ref PSNR {psnr:.2f} dB <= {PSNR_BAR}")

    # K2: the fused decoder path against the unfused one, on one AdaIN output
    with torch.no_grad():
        featq = vgg_fast.apply_encoder_q8s_fused(ep, (images_u8.float() / 255.0).to(torch.bfloat16))
        t = fused_adain(featq, s_means[0], s_stds[0], 1.0)
        for fn in counters.values():
            fn.launches = 0
        dec_fused = vgg_fast.apply_decoder_q8s_fused(dp, t)
        torch.cuda.synchronize()
        if decoder_level1.launches != 1 or qconv3x3_s8.launches != 7:
            fail(f"apply_decoder_q8s_fused: K2 {decoder_level1.launches}, K0 "
                 f"{qconv3x3_s8.launches} launches, expected 1 and 7")
        check_equal(torch, "apply_decoder_q8s_fused vs apply_decoder_q8s", dec_fused,
                    vgg_fast.apply_decoder_q8s(dp, t))
        # one style's whole int8 decode either way, on the device from a replayed graph
        decode_ms = {name: graph_ms(torch, lambda f=fn: f(dp, t), 10, 5)["median"]
                     for name, fn in (("int8-decode-fused", vgg_fast.apply_decoder_q8s_fused),
                                      ("int8-decode-unfused", vgg_fast.apply_decoder_q8s))}
    print("apply_decoder_q8s_fused (K2) equals apply_decoder_q8s bit for bit; one style's decode "
          f"of {batch} x {SIZE}px on the device: fused {decode_ms['int8-decode-fused']:.4f} ms, "
          f"unfused {decode_ms['int8-decode-unfused']:.4f} ms")

    # the bank step on the device: one encode of a batch and its moments (K5)
    from ccst_tpu_torch.ops.welford import welford_init
    from ccst_tpu_torch.pipeline.style_bank import make_bank_step

    bank_step = make_bank_step(enc, torch.bfloat16, dev)
    bank_images = images_u8.float() / 255.0
    bank_state = welford_init(512, dev)
    bank_ms = time_ms(torch, lambda: bank_step(bank_state, bank_images, batch), reps=3, runs=5)
    print(f"bank step on the device ({batch} x {SIZE}px, bf16): {bank_ms:.3f} ms/batch = "
          f"{batch / (bank_ms * 1e-3):.1f} img/s")

    rates = {"bank-step": dict(ms=bank_ms, img_s=batch / (bank_ms * 1e-3)),
             **{name: dict(ms=ms) for name, ms in decode_ms.items()}}
    for name, eng in (("ref", engine), *engines.items(), ("ref-float32", engine32)):
        ms = time_ms(torch, lambda: eng.stylize_multi(images_u8, s_means, s_stds, 1.0),
                     reps=3, runs=5)
        # the same batch captured into one CUDA graph and replayed: the card's own
        # time, with no host between the launches
        dev_ms = graph_ms(torch, lambda: eng.stylize_multi(images_u8, s_means, s_stds, 1.0), 1, 5)
        rates[name] = dict(ms=ms, img_s=batch * n_styles / (ms * 1e-3), graph_ms=dev_ms["median"])
        print(f"stylize_multi {name} on the device ({batch} x {SIZE}px, {n_styles} styles): "
              f"{ms:.2f} ms/batch = {rates[name]['img_s']:.1f} stylized img/s; as one replayed "
              f"CUDA graph {dev_ms['median']:.2f} ms ({100 * (1 - dev_ms['median'] / ms):.1f}% of "
              "the eager time is the host's)")
    print("device rates: " + json.dumps({"batch": batch, **rates}))

    # -- 6. the int8 A/B harnesses -----------------------------------------
    for k, v in run_harnesses(torch, counters).items():
        launches[k] = v

    sources = {
        "K3": ("reflect_conv3x3", "cuda", "ccst_tpu_torch/csrc/reflect_conv3x3.cu",
               "ccst_tpu/kernels/conv_pallas.py:102", list(K3_MAIN), "stylize ref"),
        "K4": ("fused_adain_multi", "cuda", "ccst_tpu_torch/csrc/adain.cu",
               "ccst_tpu/kernels/adain_pallas.py:56", list(relu4_1_shape(batch)),
               "stylize ref, int8-fused"),
        "K5": ("channel_moments", "cuda", "ccst_tpu_torch/csrc/moments.cu",
               "ccst_tpu/kernels/welford_pallas.py:52", list(relu4_1_shape(batch)), "style-bank"),
        "K0": ("qconv3x3_s8", "cuda", "ccst_tpu_torch/csrc/qconv3x3_s8.cu",
               "ccst_tpu/models/vgg_fast.py:381", list(K0_MAIN), "stylize int8-fused"),
        "K1": ("encoder_level1", "cuda", "ccst_tpu_torch/csrc/level1_s8.cu",
               "ccst_tpu/kernels/level1_pallas.py:367", [4, 256, 256, 12], "stylize int8-fused"),
        "K2": ("decoder_level1", "cuda", "ccst_tpu_torch/csrc/level1_s8.cu",
               "ccst_tpu/kernels/level1_pallas.py:380", [4, 256, 256, 64],
               "stylize int8-fused"),
        "B1": ("tiled_mm", "cuda", "ccst_tpu_torch/csrc/int8_mm.cu",
               "benchmarks/pallas_int8_mxu.py:22", B1_MAIN,
               "python -m ccst_tpu_torch.benchmarks.int8_mm"),
        "B2-direct": ("conv_direct", "cuda", "ccst_tpu_torch/csrc/qconv3x3_s8.cu",
                      "benchmarks/winograd_ab.py:73", list(B2_MAIN),
                      "python -m ccst_tpu_torch.benchmarks.winograd_ab"),
        "B2-wino": ("conv_wino", "cuda", "ccst_tpu_torch/csrc/winograd_s8.cu",
                    "benchmarks/winograd_ab.py:90", list(B2_MAIN),
                    "python -m ccst_tpu_torch.benchmarks.winograd_ab"),
        "B3": ("pool_conv_fused", "cuda", "ccst_tpu_torch/csrc/pool_conv_s8.cu",
               "benchmarks/fused_pool_conv_ab.py:123", [*B3_MAIN, 256],
               f"python -m ccst_tpu_torch.benchmarks.fused_pool_conv_ab --batch {B3_HARNESS_BATCH}"),
    }
    kernels = []
    for k, (name, route, source, replaces, shape, path) in sources.items():
        rows = results[k]
        # the row of the case the main paths launch: K4 restyles all the banks at once
        main_row = next(r for r in rows if r["shape"] == shape and "ms" in r
                        and r.get("styles", n_styles) == n_styles
                        and r.get("relu", True) and r.get("dtype", "torch.bfloat16") == "torch.bfloat16"
                        and r.get("variant", "i8i32") in ("i8i32", "F9")
                        and r.get("mode", "full") in ("direct", "full") and not r.get("cat", False))
        library_ms = main_row.get("cudnn_bf16_ms", main_row.get("library_ms"))
        per_shape = [
            {key: r.get(key) for key in ("layer", "variant", "mode", "dtype", "alpha", "styles",
                                         "kernel_variant", "shape", "ms", "graph_ms", "plain_ms",
                                         "bound_ms", "bound_by", "cudnn_bf16_ms", "cudnn_f32_ms",
                                         "library_ms", "cublas_bf16_out_ms", "single_launches_ms",
                                         "call_ms", "empty_launch_ms", "replaces_chain_ms", "k0_ms")
             if key in r}
            for r in rows if "ms" in r
        ]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[k], "path": path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": library_ms, "timed_shape": shape,
            **({"call_ms": main_row["call_ms"]} if k == "K2" else {}),
            **({"replaces_chain_ms": main_row["replaces_chain_ms"]} if k in ("K2", "B3") else {}),
            **({"k0_ms": main_row["k0_ms"]} if k.startswith("B2") else {}),
            **({"timed_styles": main_row["styles"]} if "styles" in main_row else {}),
            **({"tops": main_row["tops"]} if "tops" in main_row else {}),
            **({"shapes": per_shape} if per_shape else {}),
        })
    print(f"wall: {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
