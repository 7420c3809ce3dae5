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
     bf16 conv timed beside it for comparison only, K4 AdaIN, K5 moments with
     their tolerances; K0 int8 conv at every shape of the int8 engines, K1
     fused level-1 encoder and K2 fused level-1 decoder bit for bit; the int8 A/B
     kernels bit for bit at the harnesses' full-width shapes: B1 tiled GEMM
     (int8 -> int32, int8 -> float32, bf16 -> float32, M = 2^18, the five
     (K, N) of the sweep; beside it, for comparison only, the one library call
     that computes the same function: ``torch._int_mm`` for int8 -> int32 and
     ``torch.mm(x, w, out_dtype=torch.float32)`` for bf16 -> float32; the
     bf16-output ``torch.matmul`` is timed under its own name, since it writes
     half the output bytes), B2
     direct and Winograd conv (full, dots, tf) at (8, 256, 256, 256 -> 256),
     B3 fused pool1 + conv2_1 (F9, F3) at (128, 256, 256, 256); then ragged
     shapes (odd planes, Cout = 12, one-row tiles, M and N off the tiles);
  4. the main paths through the CLI entry point, in this process, each with
     every launch count zeroed before it and read after it: ``style-bank``
     for four synthetic PACS domains, ``stylize --target photo --mode
     overall`` (bf16 ``ref`` engine), ``calibrate --target photo``, then
     ``stylize --engine int8-fused`` at 512 px in bfloat16 with seeded random
     weights; outputs must exist and be finite, and every kernel's launch
     count must be exactly what the path implies;
  5. on one 512 px batch: the ``ref`` path against the same path composed
     from the plain versions (MAE <= 1e-3); ``int8-fused`` against its plain
     composition (MAE <= 1e-3), against ``int8-static`` (bit for bit) and
     against ``ref`` (PSNR > 20 dB); ``apply_decoder_q8s_fused`` (K2) against
     ``apply_decoder_q8s`` (bit for bit); device-only ``stylize_multi`` times
     of the three engines;
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
``launches`` are the phase-4 main paths' counts (K2 is on none of them) and,
for B1-B3, the phase-6 harnesses' counts, and whose ``bound_ms`` / ``bound_by``
/ ``library_ms`` are those of its ``timed_shape`` (K3, K0 and B1 list every
main-path shape, B1 every variant, under ``shapes``); the last line is ``{"ok": true, "device":
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
# each way with both edges ragged, exactly one tile, one column of tiles
LEVEL1_EDGE = [(1, 18, 10), (2, 7, 33), (1, 1, 3), (2, 19, 37), (1, 8, 16), (1, 250, 6)]
# B1 at the sweep of benchmarks/pallas_int8_mxu.py: (M, K, N); ragged: M not
# a multiple of the 192-row tile, N not of the 128-column tile, K ending
# inside a 128-byte stage in both element types, fewer rows than one wgmma
B1_M = 1 << 18
B1_SHAPES = [(256, 256), (512, 512), (2304, 256), (576, 256), (1152, 128)]
B1_MAIN = [B1_M, 2304, 256]
B1_EDGE = [(1000, 48, 24), (77, 2304, 136), (300, 80, 40), (5, 256, 128)]
# B2 at the packed conv1_2 shape of benchmarks/winograd_ab.py; ragged: odd
# planes (partial 2x2 tiles), one row
B2_MAIN = (8, 256, 256, 256, 256)
B2_EDGE = [(1, 17, 37, 64, 64), (2, 9, 20, 128, 64), (1, 1, 3, 64, 128)]
# B3 at benchmarks/fused_pool_conv_ab.py's B = 128; ragged: odd planes, 2x2
B3_MAIN = (128, 256, 256)
B3_EDGE = [(1, 7, 13), (2, 2, 2), (3, 33, 5)]
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
    """A timing reference only, on no path: cuDNN's bf16 conv (channels_last)
    on an input reflect-padded beforehand, bias in the conv, no ReLU."""
    F = torch.nn.functional
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    xp = xp.contiguous(memory_format=torch.channels_last)
    w = cw.w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    b = cw.b.to(x.dtype)
    return lambda: F.conv2d(xp, w, b)


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
    from ccst_tpu_torch.kernels.level1 import (
        decoder_level1,
        decoder_level1_reference,
        encoder_level1,
        encoder_level1_reference,
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
        results["K0"].append(dict(layer=layer, shape=[n, h, w, cin, cout], pad=pad,
                                  requant=requant, relu=relu, max_abs_err=0.0, ms=ms,
                                  plain_ms=plain_ms, tops=tops,
                                  peak_share=tops / INT8_PEAK_TOPS, **bd))
        print(f"K0 qconv {layer} {(n, h, w, cin, cout)} {pad} "
              f"{'requant' if requant else 'dequant bf16'} relu={relu}: bit-exact "
              f"| kernel {ms:.4f} ms ({tops:.1f} TOPS, {100 * tops / INT8_PEAK_TOPS:.1f}% "
              f"of {INT8_PEAK_TOPS:.0f}) bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
              f"({100 * bd['bound_ms'] / ms:.1f}% reached) plain f64 {plain_ms:.4f} ms")

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
        got2 = decoder_level1(y, d2, d1)
        torch.cuda.synchronize()
        check_equal(torch, f"K2 {tag} {(n, hb, wb, 64)}", got2,
                    decoder_level1_reference(y, d2, d1, torch.bfloat16))
        if tag != "main":
            continue
        if len(torch.unique(got)) < 20:
            fail("K1: outputs do not spread, the comparison would say little")
        # per packed pixel: the chain's MACs, the bytes in and out, the weights' bytes
        for k, kernel, plain, macs, px_bytes, w_bytes in (
            ("K1", lambda: encoder_level1(x, c1, c2, lw),
             lambda: encoder_level1_reference(x, c1, c2), 108 * 256 + 2304 * 256, 12 + 64,
             108 * 256 + 2304 * 256),
            ("K2", lambda: decoder_level1(y, d2, d1),
             lambda: decoder_level1_reference(y, d2, d1, torch.bfloat16), 576 * 256 + 2304 * 12,
             64 + 2 * 12, 576 * 256 + 2304 * 12),
        ):
            ms = time_ms(torch, kernel)
            plain_ms = time_ms(torch, plain, reps=2, runs=3)
            tops = 2 * n * hb * wb * macs / (ms * 1e-3) / 1e12
            bd = bound(2 * n * hb * wb * macs, INT8_PEAK_TOPS, n * hb * wb * px_bytes + w_bytes)
            results[k].append(dict(shape=[n, hb, wb, 12 if k == "K1" else 64], max_abs_err=0.0,
                                   ms=ms, plain_ms=plain_ms, tops=tops, **bd))
            print(f"{k} level1 {(n, hb, wb)} packed: bit-exact | kernel {ms:.4f} ms "
                  f"({tops:.1f} TOPS of the unfused chain's MACs) bound {bd['bound_ms']:.4f} ms by "
                  f"{bd['bound_by']} ({100 * bd['bound_ms'] / ms:.1f}% reached) "
                  f"plain f64 chain {plain_ms:.4f} ms")
    torch.cuda.synchronize()
    print("edge shapes: K0, K1, K2 equal their plain versions")


def check_ab_kernels(torch, dev, cpu_gen, results):
    """Phase 3, A/B part: B1, B2 (direct, Winograd in its three modes) and B3
    (F9, F3) bit for bit against their plain versions at the harnesses'
    full-width shapes, with times; then ragged shapes."""
    import numpy as np

    from ccst_tpu_torch import benchmarks as bm
    from ccst_tpu_torch.benchmarks.int8_mm import VARIANTS
    from ccst_tpu_torch.kernels import winograd as wg
    from ccst_tpu_torch.kernels.int8_mm import prepare_mm_weight, tiled_mm, tiled_mm_reference
    from ccst_tpu_torch.kernels.pool_conv import pool_conv_fused, pool_conv_reference

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
        for kid, mode, kernel, plain in cases:
            got = kernel()
            torch.cuda.synchronize()
            check_equal(torch, f"{kid} {mode} {(n, h, w, cin, cout)}", got, plain())
            if (n, h, w, cin, cout) != B2_MAIN:
                continue
            if mode in ("direct", "full") and len(torch.unique(got)) < 20:
                fail(f"{kid} {mode}: outputs do not spread, the comparison would say little")
            ms = time_ms(torch, kernel)
            plain_ms = time_ms(torch, plain, reps=2, runs=3)
            tops = 2 * n * h * w * 9 * cin * cout / (ms * 1e-3) / 1e12
            results[kid].append(dict(shape=[n, h, w, cin, cout], mode=mode, max_abs_err=0.0,
                                     ms=ms, plain_ms=plain_ms, tops=tops))
            # Winograd F(2x2, 3x3) multiplies 16 positions per 2 x 2 outputs, not 36
            bd = conv_bound((n, h, w, cin, cout), INT8_PEAK_TOPS, 1, 1)
            if kid == "B2-wino":
                bd = bound(2 * n * h * w * 4 * cin * cout, INT8_PEAK_TOPS,
                           n * h * w * (cin + cout) + 16 * cin * cout)
            results[kid][-1].update(bd)
            print(f"{kid} {mode} {(n, h, w, cin, cout)}: bit-exact | kernel {ms:.4f} ms "
                  f"({tops:.1f} direct-conv TOPS) bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                  f"plain f64 {plain_ms:.4f} ms")

    for (n, hb, wb) in (B3_MAIN, *B3_EDGE):
        xp = torch.randint(-5, 120, (n, hb, wb, 256), generator=gen, dtype=torch.int8, device=dev)
        q = int8_layer(torch, cpu_gen, 64, 128, True, dev)
        plain = lambda: torch.cat([pool_conv_reference(xp[i:i + 16], q) for i in range(0, n, 16)])
        want = plain()
        for tag, cat in (("F9", False), ("F3", True)):
            got = pool_conv_fused(xp, q, cat)
            torch.cuda.synchronize()
            check_equal(torch, f"B3 {tag} {(n, hb, wb, 256)}", got, want)
            if (n, hb, wb) != B3_MAIN:
                continue
            if len(torch.unique(got)) < 20:
                fail(f"B3 {tag}: outputs do not spread, the comparison would say little")
            ms = time_ms(torch, lambda c=cat: pool_conv_fused(xp, q, c))
            plain_ms = time_ms(torch, plain, reps=1, runs=3)
            tops = 2 * n * hb * wb * 576 * 128 / (ms * 1e-3) / 1e12
            bd = bound(2 * n * hb * wb * 576 * 128, INT8_PEAK_TOPS,
                       n * hb * wb * (256 + 128) + 576 * 128)
            results["B3"].append(dict(shape=[n, hb, wb, 256], cat=cat, max_abs_err=0.0, ms=ms,
                                      plain_ms=plain_ms, tops=tops, **bd))
            print(f"B3 pool_conv {tag} {(n, hb, wb, 256)}: bit-exact | kernel {ms:.4f} ms "
                  f"({tops:.1f} TOPS) bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                  f"plain (phase max + f64 conv) {plain_ms:.4f} ms")
        del want
    torch.cuda.synchronize()
    print("edge shapes: B1, B2, B3 equal their plain versions")


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

    from ccst_tpu_torch.kernels import _build
    from ccst_tpu_torch.kernels.adain import fused_adain, fused_adain_reference
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
    from ccst_tpu_torch.kernels.moments import channel_moments, channel_moments_reference
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
                print(f"K3 conv {layer} {(n, h, w, cin, cout)}: max {mx:.3e} mean {mean:.3e} "
                      f"| kernel {ms:.4f} ms ({flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s) bound "
                      f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({100 * bd['bound_ms'] / ms:.1f}% "
                      f"reached) cuDNN bf16 {lib:.4f} ms ({flop / (lib * 1e-3) / 1e12:.1f} TFLOP/s) "
                      f"plain f32 {plain:.4f} ms")
            else:
                print(f"K3 conv {layer} {(n, h, w, cin, cout)} relu=False: max {mx:.3e} mean {mean:.3e}")
            results["K3"].append(row)

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, dict(rtol=1e-5, atol=1e-5))):
        for alpha in (1.0, 0.6):
            feat = (torch.randn((4, 64, 64, 512), generator=gen) * 2 + 1).to(dev, dtype)
            s_mean = torch.randn((512,), generator=gen).to(dev)
            s_std = (torch.rand((512,), generator=gen) + 0.1).to(dev)
            got = fused_adain(feat, s_mean, s_std, alpha)
            torch.cuda.synchronize()
            want = fused_adain_reference(feat, s_mean, s_std, alpha)
            mx, mean = check_close(f"K4 {dtype} alpha={alpha}", got, want, **tol)
            ms = time_ms(torch, lambda: fused_adain(feat, s_mean, s_std, alpha), reps=50)
            plain = time_ms(torch, lambda: fused_adain_reference(feat, s_mean, s_std, alpha), reps=50)
            # two passes of a few float32 operations an element; the tensor in and out
            bd = bound(10 * feat.numel(), F32_PEAK_TFLOPS, 2 * feat.numel() * feat.element_size())
            results["K4"].append(dict(shape=[4, 64, 64, 512], dtype=str(dtype), alpha=alpha,
                                      max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain, **bd))
            print(f"K4 adain (4, 64, 64, 512) {dtype} alpha={alpha}: max {mx:.3e} "
                  f"mean {mean:.3e} | kernel {ms:.4f} ms bound {bd['bound_ms']:.4f} ms by "
                  f"{bd['bound_by']} plain {plain:.4f} ms")

    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((3, 64, 64, 512), (3, 64, 64, 500)):
            feat = (torch.randn(shape, generator=gen) * 3 + 10).to(dev, dtype)
            mean, m2, count = channel_moments(feat)
            torch.cuda.synchronize()
            r_mean, r_m2, r_count = channel_moments_reference(feat)
            if count.item() != r_count.item():
                fail(f"K5 {shape}: count {count.item()} != {r_count.item()}")
            mx1, av1 = check_close(f"K5 mean {shape} {dtype}", mean, r_mean, rtol=1e-5, atol=0.0)
            mx2, av2 = check_close(f"K5 m2 {shape} {dtype}", m2, r_m2, rtol=1e-4, atol=0.0)
            ms = time_ms(torch, lambda: channel_moments(feat), reps=50)
            plain = time_ms(torch, lambda: channel_moments_reference(feat), reps=50)
            # one read of the tensor, a few float32 operations an element
            bd = bound(6 * feat.numel(), F32_PEAK_TFLOPS, feat.numel() * feat.element_size())
            results["K5"].append(dict(shape=list(shape), dtype=str(dtype), max_abs_err=max(mx1, mx2),
                                      mean_max_abs_err=mx1, m2_max_abs_err=mx2, ms=ms, plain_ms=plain,
                                      **bd))
            print(f"K5 moments {shape} {dtype}: mean max {mx1:.3e} avg {av1:.3e}, "
                  f"m2 max {mx2:.3e} avg {av2:.3e} "
                  f"| kernel {ms:.4f} ms bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                  f"plain {plain:.4f} ms")

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
    for shape in ((2, 7, 9, 100), (1, 1, 1, 16)):
        feat = (torch.randn(shape, generator=gen) + 3).to(dev)
        s_mean, s_std = torch.randn(shape[-1:], generator=gen).to(dev), torch.ones(shape[-1:]).to(dev)
        if shape[1] * shape[2] > 1:
            check_close(f"K4 edge {shape}", fused_adain(feat, s_mean, s_std, 0.6),
                        fused_adain_reference(feat, s_mean, s_std, 0.6), rtol=1e-5, atol=1e-5)
        for got, want in zip(channel_moments(feat), channel_moments_reference(feat)):
            check_close(f"K5 edge {shape}", got, want, rtol=1e-4, atol=1e-5)
    torch.cuda.synchronize()
    print("edge shapes: K3, K4, K5 agree with their plain versions")

    check_int8_kernels(torch, dev, gen, results)
    check_ab_kernels(torch, dev, gen, results)

    # -- 4. the main paths through the CLI ---------------------------------
    import numpy as np

    from ccst_tpu_torch import cli
    from ccst_tpu_torch.models import convert, vgg, vgg_fast
    from ccst_tpu_torch.pipeline.style_bank import load_style_stats
    from ccst_tpu_torch.pipeline.stylize import StylizeEngine

    counters = {"K3": reflect_conv3x3, "K4": fused_adain, "K5": channel_moments,
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

        def common(out_root):
            return [
                "--dataset", "pacs", "--list-root", root, "--data-root", root,
                "--output-root", out_root, "--style-stats-dir", stats_dir,
                "--image-size", str(SIZE), "--batch-size", str(batch), "--dtype", "bfloat16",
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
             {"K3": (9 + 9 * n_styles) * n_content_batches, "K4": n_styles * n_content_batches}),
            ("calibrate", ["calibrate", *common(root), *target, "--engine", "int8-fused"], {}),
            ("stylize int8-fused", ["stylize", *common(int8_root), *target, "--mode", "overall",
                                    "--engine", "int8-fused"],
             {"K0": (7 + 9 * n_styles) * n_content_batches, "K1": n_content_batches,
              "K4": n_styles * n_content_batches}),
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
        for k in ("K0", "K1", "K3", "K4", "K5"):
            if launches[k] == 0:
                fail(f"{k} was never launched on the main paths")

        for d in DOMAINS:
            mean, std = load_style_stats(os.path.join(stats_dir, "pacs", f"{d}_mean_std.npz"))
            if mean.shape != (512,) or not (np.isfinite(mean).all() and np.isfinite(std).all()):
                fail(f"bank {d}: bad shape or non-finite values")
            with open(os.path.join(stats_dir, "pacs", f"{d}_style_comp_time.json")) as f:
                t = json.load(f)
            print(f"style-bank {d}: {t['images']} images in {t['seconds']:.3f} s = "
                  f"{t['images_per_sec']:.1f} img/s at {SIZE} px")
        scales_path = os.path.join(stats_dir, "pacs", "photo_q8_scales.json")
        scales = vgg_fast.load_scales(scales_path,
                                      expect_fingerprint=vgg_fast.weights_fingerprint(enc, dec))
        if len(scales) != 18 or not all(math.isfinite(v) and v > 0 for v in scales.values()):
            fail(f"calibrate wrote bad scales: {scales}")
        print(f"calibrate: {len(scales)} scales, {min(scales.values()):.4g}..{max(scales.values()):.4g}")
        for engine_name, out_root in (("ref", root), ("int8-fused", int8_root)):
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
    for name, per_batch in (("int8-fused", {"K0": 7 + 9 * n_styles, "K1": 1}),
                            ("int8-static", {"K0": 9 + 9 * n_styles, "K1": 0})):
        for fn in counters.values():
            fn.launches = 0
        q8[name] = engines[name].stylize_multi(images_u8, s_means, s_stds, 1.0)
        torch.cuda.synchronize()
        counts = {k: counters[k].launches for k in ("K0", "K1", "K2", "K3", "K4")}
        expect = {"K2": 0, "K3": 0, "K4": n_styles, **per_batch}
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

    # K2: the fused decoder path against the unfused one, on the AdaIN output
    with torch.no_grad():
        featq = vgg_fast.apply_encoder_q8s_fused(ep, (images_u8.float() / 255.0).to(torch.bfloat16))
        t = fused_adain(featq, s_means[0], s_stds[0], 1.0)
        for fn in counters.values():
            fn.launches = 0
        dec_fused = vgg_fast.apply_decoder_q8s_fused(dp, t)
        torch.cuda.synchronize()
        k2_launches = decoder_level1.launches
        if k2_launches != 1 or qconv3x3_s8.launches != 7:
            fail(f"apply_decoder_q8s_fused: K2 {k2_launches}, K0 {qconv3x3_s8.launches} "
                 "launches, expected 1 and 7")
        check_equal(torch, "apply_decoder_q8s_fused vs apply_decoder_q8s", dec_fused,
                    vgg_fast.apply_decoder_q8s(dp, t))
    print("apply_decoder_q8s_fused (K2) equals apply_decoder_q8s bit for bit")

    rates = {}
    for name, eng in (("ref", engine), *engines.items()):
        ms = time_ms(torch, lambda: eng.stylize_multi(images_u8, s_means, s_stds, 1.0),
                     reps=3, runs=5)
        rates[name] = dict(ms=ms, img_s=batch * n_styles / (ms * 1e-3))
        print(f"stylize_multi {name} on the device ({batch} x {SIZE}px, {n_styles} styles): "
              f"{ms:.2f} ms/batch = {rates[name]['img_s']:.1f} stylized img/s")
    print("device rates: " + json.dumps({"batch": batch, **rates}))

    # -- 6. the int8 A/B harnesses -----------------------------------------
    for k, v in run_harnesses(torch, counters).items():
        launches[k] = v

    sources = {
        "K3": ("reflect_conv3x3", "cuda", "ccst_tpu_torch/csrc/reflect_conv3x3.cu",
               "ccst_tpu/kernels/conv_pallas.py:102", list(K3_MAIN), "stylize ref"),
        "K4": ("fused_adain", "triton", "ccst_tpu_torch/kernels/adain_triton.py",
               "ccst_tpu/kernels/adain_pallas.py:56", [4, 64, 64, 512], "stylize ref, int8-fused"),
        "K5": ("channel_moments", "triton", "ccst_tpu_torch/kernels/moments_triton.py",
               "ccst_tpu/kernels/welford_pallas.py:52", [3, 64, 64, 512], "style-bank"),
        "K0": ("qconv3x3_s8", "cuda", "ccst_tpu_torch/csrc/qconv3x3_s8.cu",
               "ccst_tpu/models/vgg_fast.py:381", list(K0_MAIN), "stylize int8-fused"),
        "K1": ("encoder_level1", "cuda", "ccst_tpu_torch/csrc/level1_s8.cu",
               "ccst_tpu/kernels/level1_pallas.py:367", [4, 256, 256, 12], "stylize int8-fused"),
        "K2": ("decoder_level1", "cuda", "ccst_tpu_torch/csrc/level1_s8.cu",
               "ccst_tpu/kernels/level1_pallas.py:380", [4, 256, 256, 64],
               "none: no engine decodes through it (as in ccst_tpu)"),
        "B1": ("tiled_mm", "cuda", "ccst_tpu_torch/csrc/int8_mm.cu",
               "benchmarks/pallas_int8_mxu.py:22", B1_MAIN,
               "python -m ccst_tpu_torch.benchmarks.int8_mm"),
        "B2-direct": ("conv_direct", "cuda", "ccst_tpu_torch/csrc/winograd_s8.cu",
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
        main_row = next(r for r in rows if r["shape"] == shape and "ms" in r
                        and r.get("relu", True) and r.get("dtype", "torch.bfloat16") == "torch.bfloat16"
                        and r.get("variant", "i8i32") == "i8i32"
                        and r.get("mode", "full") in ("direct", "full") and not r.get("cat", False))
        library_ms = main_row.get("cudnn_bf16_ms", main_row.get("library_ms"))
        per_shape = [
            {key: r.get(key) for key in ("layer", "variant", "shape", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "cudnn_bf16_ms", "library_ms",
                                         "cublas_bf16_out_ms") if key in r}
            for r in rows if k in ("K3", "K0", "B1") and "ms" in r
        ]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[k], "path": path,
            # K2's launches in phase 5's direct apply_decoder_q8s_fused call
            **({"side_check_launches": k2_launches} if k == "K2" else {}),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": library_ms, "timed_shape": shape,
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
