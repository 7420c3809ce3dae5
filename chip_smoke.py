#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``ccst_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and exits non-zero
without one. It imports nothing of JAX. Phases, each of which fails the run:

  1. device: the card's name and power limit (nvidia-smi), TF32 off so the
     float32 plain references are true float32;
  2. build: the CUDA kernel library from ``ccst_tpu_torch/csrc``;
  3. each kernel (K3 conv, K4 AdaIN, K5 moments) against its plain PyTorch
     version on the card at the shapes of the 512 px path, with its
     tolerance, and the median time of both;
  4. the main path through the CLI entry point, in this process:
     ``style-bank`` for four synthetic PACS domains, then
     ``stylize --target photo --mode overall`` at 512 px in bfloat16, with
     seeded random weights; the outputs must exist and be finite, and every
     kernel's launch count must be exactly what the path implies;
  5. the whole stylize path against the same path composed from the plain
     versions, on the same weights and a 512 px batch: MAE <= 1e-3.

The random decoder's last conv is rescaled (x12, bias +0.5) so that stylized
outputs spread over [0, 1] as real ones do: the MAE bar is then 0.1% of the
output's range, as it is for a real image, and the PNGs the CLI writes are not
near-constant.

    python3 chip_smoke.py --images-per-domain 512 --batch-size 32

runs the same phases on a larger synthetic tree, for a disk-to-disk rate over
more than the first few batches.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # same bf16 operands, f32 sums in another order
MAE_BAR = 1e-3                         # ROADMAP.md / BASELINE stylize bar
MIN_SPREAD = 0.5                       # the bar above assumes outputs spread over [0, 1]
DOMAINS = ("art_painting", "cartoon", "photo", "sketch")
SIZE = 512
DEC_SCALE, DEC_SHIFT = 12.0, 0.5       # last decoder conv: outputs spread over [0, 1]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images-per-domain", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    args = ap.parse_args()
    images_per_domain, batch = args.images_per_domain, args.batch_size
    if images_per_domain < batch:
        raise SystemExit("chip_smoke: --images-per-domain must be at least --batch-size")

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
    from ccst_tpu_torch.kernels.conv import (
        prepare_conv,
        reflect_conv3x3,
        reflect_conv3x3_reference,
    )
    from ccst_tpu_torch.kernels.moments import channel_moments, channel_moments_reference

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
    results = {"K3": [], "K4": [], "K5": []}

    conv_shapes = [
        (4, 512, 512, 3, 64), (4, 512, 512, 64, 64), (4, 128, 128, 256, 256),
        (4, 64, 64, 256, 512), (4, 512, 512, 64, 3), (2, 37, 53, 64, 128),
    ]
    for (n, h, w, cin, cout) in conv_shapes:
        x = torch.randn((n, h, w, cin), generator=gen).to(dev, torch.bfloat16)
        bound = (1.0 / (9 * cin)) ** 0.5
        wt = (torch.rand((3, 3, cin, cout), generator=gen) * 2 - 1) * bound
        b = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
        cw = prepare_conv(wt, b, torch.bfloat16, dev)
        for relu in (True, False):
            got = reflect_conv3x3(x, cw, relu)
            torch.cuda.synchronize()
            want = reflect_conv3x3_reference(x, cw.w, cw.b, relu)
            mx, mean = check_close(f"K3 {(n, h, w, cin, cout)} relu={relu}", got, want, **BF16_TOL)
            ms = time_ms(torch, lambda: reflect_conv3x3(x, cw, relu))
            plain = time_ms(torch, lambda: reflect_conv3x3_reference(x, cw.w, cw.b, relu))
            flop = 2 * n * h * w * 9 * cin * cout
            row = dict(shape=[n, h, w, cin, cout], relu=relu, max_abs_err=mx,
                       mean_abs_err=mean, ms=ms, plain_ms=plain)
            line = (f"K3 conv {(n, h, w, cin, cout)} relu={relu}: max {mx:.3e} mean {mean:.3e} "
                    f"| kernel {ms:.4f} ms ({flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s) "
                    f"plain f32 {plain:.4f} ms")
            if relu:
                torch.backends.cudnn.benchmark = True
                row["cudnn_bf16_ms"] = time_ms(torch, cudnn_bf16_conv(torch, x, cw))
                torch.backends.cudnn.benchmark = False
                line += (f" cuDNN bf16 {row['cudnn_bf16_ms']:.4f} ms "
                         f"({flop / (row['cudnn_bf16_ms'] * 1e-3) / 1e12:.1f} TFLOP/s)")
            results["K3"].append(row)
            print(line)

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
            results["K4"].append(dict(shape=[4, 64, 64, 512], dtype=str(dtype), alpha=alpha,
                                      max_abs_err=mx, mean_abs_err=mean, ms=ms, plain_ms=plain))
            print(f"K4 adain (4, 64, 64, 512) {dtype} alpha={alpha}: max {mx:.3e} "
                  f"mean {mean:.3e} | kernel {ms:.4f} ms plain {plain:.4f} ms")

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
            results["K5"].append(dict(shape=list(shape), dtype=str(dtype), max_abs_err=max(mx1, mx2),
                                      mean_max_abs_err=mx1, m2_max_abs_err=mx2, ms=ms, plain_ms=plain))
            print(f"K5 moments {shape} {dtype}: mean max {mx1:.3e} avg {av1:.3e}, "
                  f"m2 max {mx2:.3e} avg {av2:.3e} "
                  f"| kernel {ms:.4f} ms plain {plain:.4f} ms")

    # ragged edges, correctness only: pixels not a multiple of the 128-row
    # tile, the smallest reflectable plane, the scalar Cin = 3 gather, one row
    for (n, h, w, cin, cout) in ((1, 2, 2, 64, 64), (3, 17, 9, 128, 3), (1, 5, 3, 3, 64)):
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

    # -- 4. the main path through the CLI ----------------------------------
    import numpy as np

    from ccst_tpu_torch import cli
    from ccst_tpu_torch.models import convert, vgg
    from ccst_tpu_torch.pipeline.style_bank import load_style_stats
    from ccst_tpu_torch.pipeline.stylize import StylizeEngine

    counters = {"K3": reflect_conv3x3, "K4": fused_adain, "K5": channel_moments}
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
        common = [
            "--dataset", "pacs", "--list-root", root, "--data-root", root,
            "--output-root", root, "--style-stats-dir", stats_dir,
            "--image-size", str(SIZE), "--batch-size", str(batch), "--dtype", "bfloat16",
            "--vgg-weights", enc_path, "--decoder-weights", dec_path, "--device", "cuda",
        ]
        n_bank_batches = len(DOMAINS) * -(-images_per_domain // batch)
        n_styles = len(DOMAINS) - 1
        n_content_batches = -(-images_per_domain // batch)
        expect = {
            "style-bank": {"K3": 9 * n_bank_batches, "K4": 0, "K5": n_bank_batches},
            "stylize": {"K3": (9 + 9 * n_styles) * n_content_batches,
                        "K4": n_styles * n_content_batches, "K5": 0},
        }
        launches = {k: 0 for k in counters}
        for fn in counters.values():
            fn.launches = 0
        for step, argv in (
            ("style-bank", ["style-bank", *common]),
            ("stylize", ["stylize", *common, "--target", "photo", "--mode", "overall"]),
        ):
            before = {k: fn.launches for k, fn in counters.items()}
            if cli.main(argv) != 0:
                fail(f"{step} returned non-zero")
            torch.cuda.synchronize()
            got = {k: fn.launches - before[k] for k, fn in counters.items()}
            if got != expect[step]:
                fail(f"{step}: kernel launches {got}, expected {expect[step]}")
            print(f"{step}: kernel launches {got} (as expected)")
        for k, fn in counters.items():
            launches[k] = fn.launches
            if launches[k] == 0:
                fail(f"{k} was never launched on the main path")

        for d in DOMAINS:
            mean, std = load_style_stats(os.path.join(stats_dir, "pacs", f"{d}_mean_std.npz"))
            if mean.shape != (512,) or not (np.isfinite(mean).all() and np.isfinite(std).all()):
                fail(f"bank {d}: bad shape or non-finite values")
            with open(os.path.join(stats_dir, "pacs", f"{d}_style_comp_time.json")) as f:
                t = json.load(f)
            print(f"style-bank {d}: {t['images']} images in {t['seconds']:.3f} s = "
                  f"{t['images_per_sec']:.1f} img/s at {SIZE} px")
        out_dir = os.path.join(root, "PACS", "all_style_transferred_Overall", "photo")
        outputs = [os.path.join(dp, f) for dp, _, fs in os.walk(out_dir) for f in fs]
        if len(outputs) != images_per_domain * n_styles:
            fail(f"stylize wrote {len(outputs)} images, expected {images_per_domain * n_styles}")
        with open(os.path.join(root, "pacs_photo_overall_stylize_time.json")) as f:
            timing = json.load(f)
        print("stylize timing: " + json.dumps(timing))
        sample = read_images(sorted(outputs)[:batch])
        print(f"stylized PNGs: u8 range {sample.min()}..{sample.max()}, "
              f"mean {sample.mean():.1f} over {len(sample)} images")

        # -- 5. whole path vs the plain path --------------------------------
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
    print(f"whole path vs plain path ({n_styles} styles x {batch} x {SIZE}px bf16): "
          f"MAE {mae:.3e} ({mae / spread:.3e} of the output range) max {err.max().item():.3e}; "
          f"output range {want.min().item():.3f}..{want.max().item():.3f}")
    if not spread >= MIN_SPREAD:
        fail(f"outputs span {spread:.3f} < {MIN_SPREAD}: the MAE bar would say little")
    if not mae <= MAE_BAR:
        fail(f"whole-path MAE {mae:.3e} > {MAE_BAR}")
    path_ms = time_ms(torch, lambda: engine.stylize_multi(images_u8, s_means, s_stds, 1.0),
                      reps=3, runs=5)
    print(f"stylize_multi on the device ({batch} x {SIZE}px, {n_styles} styles): "
          f"{path_ms:.2f} ms/batch = {batch * n_styles / (path_ms * 1e-3):.1f} stylized img/s")

    sources = {
        "K3": ("reflect_conv3x3", "cuda", "ccst_tpu_torch/csrc/reflect_conv3x3.cu",
               "ccst_tpu/kernels/conv_pallas.py:102", [4, 512, 512, 64, 64]),
        "K4": ("fused_adain", "triton", "ccst_tpu_torch/kernels/adain_triton.py",
               "ccst_tpu/kernels/adain_pallas.py:56", [4, 64, 64, 512]),
        "K5": ("channel_moments", "triton", "ccst_tpu_torch/kernels/moments_triton.py",
               "ccst_tpu/kernels/welford_pallas.py:52", [3, 64, 64, 512]),
    }
    kernels = []
    for k, (name, route, source, replaces, shape) in sources.items():
        rows = results[k]
        main_row = next(r for r in rows if r["shape"] == shape
                        and r.get("relu", True) and r.get("dtype", "torch.bfloat16") == "torch.bfloat16")
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "timed_shape": shape,
            **({"cudnn_bf16_ms": main_row["cudnn_bf16_ms"]} if "cudnn_bf16_ms" in main_row else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
