"""Where a step of decoder training and of the privacy trainers spends its time.

    python -m ccst_tpu_torch.benchmarks.privacy_profile [--size 256] [--steps 5] \
        [--runs 3] [--warmup 2] [--device cuda|cpu]

With seeded random weights and seeded random images on the device, at
``ccst-tpu``'s default widths (float32, TF32 off), for each of

  - ``train-decoder``: one ``DecoderTrainer.step``, batch 8 (18 K3 launches in
    float32 for the frozen passes, the rest cuDNN under autograd);
  - ``invert-train``: the style vector (9 K3, bf16) and one
    ``InverterTrainer.step`` with ``--loss mse+perceptual``, batch 16 (9 K3 in
    float32 for the images' perceptual taps);
  - ``gan-train`` and ``gan-train gp``: one ``GanTrainer.train_step``, batch 8,
    ``--attn-res 32``, without and with the R1 penalty,

it times ``--steps`` steps (CUDA events, the median of ``--runs`` runs after
``--warmup`` steps), traces ``--steps`` more with ``torch.profiler`` (device time a
step by kernel family, K3 apart; the largest kernels; launches a step; the
device's idle share, 1 - kernel time / step time) and reads the peak device
memory. Then it times the two trainers' grad-free VGG passes of a step (the
18 convs that K3 runs) three ways, on the same inputs: K3 (the kernel route),
cuDNN (the autograd route's reflect pad + ``F.conv2d``, TF32 off, under
``no_grad``: the library's time) and K3's plain version
(``reflect_conv3x3_reference`` in the kernel route's place). Prints the card's
name and power limit, then one JSON object as the last line. ``--device cpu``
runs the same steps at the size given (use a tiny one): host times only, no
device number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

from ccst_tpu_torch.benchmarks.fed_profile import family as fed_family

CASES = ("train-decoder", "invert-train", "gan-train", "gan-train gp")


def family(name: str) -> str:
    return "K3" if "reflect_conv3x3" in name else fed_family(name)


def make_steps(dev, size: int):
    """{case: (step(), images a step)} on ``dev``."""
    import torch

    from ccst_tpu_torch.models import vgg
    from ccst_tpu_torch.pipeline.train_decoder import DecoderTrainConfig, DecoderTrainer
    from ccst_tpu_torch.privacy.gan import GanConfig, GanTrainer
    from ccst_tpu_torch.privacy.invert import InvertConfig, InverterTrainer, style_vector

    g = torch.Generator().manual_seed(0)
    enc = vgg.init_params(vgg.ENCODER_ARCH, g)
    dec = vgg.init_params(vgg.DECODER_ARCH, g)
    images = lambda n: torch.rand((n, size, size, 3), generator=g).to(dev)  # noqa: E731
    content, style, inv_images, real = images(8), images(8), images(16), images(8)

    decoder = DecoderTrainer(DecoderTrainConfig(), enc, dec, dev)
    inverter = InverterTrainer(InvertConfig(image_size=size, loss="mse+perceptual"), enc, dev)
    enc16 = vgg.prepare_params(enc, torch.bfloat16, dev)

    def invert_step():
        with torch.no_grad():
            z = style_vector(enc16, inv_images)
        inverter.step(inv_images, z)

    gan = GanTrainer(GanConfig(image_size=size, gp_weight=10.0, attn_res=(32,)), device=dev)
    return {"train-decoder": (lambda: decoder.step(content, style), 8),
            "invert-train": (invert_step, 16),
            # step_idx 1: gp_every is 4, so no penalty; 0: the penalty
            "gan-train": (lambda: gan.train_step(real, step_idx=1), 8),
            "gan-train gp": (lambda: gan.train_step(real, step_idx=0), 8)}


def frozen_passes(dev, size: int):
    """{case: {route: pass()}}: a step's grad-free VGG passes of each trainer
    (``train-decoder``, batch 8: the style image's taps and the content's
    relu4_1, float32; ``invert-train``, batch 16: the style vector in bf16 and
    the images' perceptual taps in float32) on the kernel route (K3), the
    autograd route (cuDNN) and the kernel route with K3's plain version."""
    import torch

    from ccst_tpu_torch.kernels.conv import reflect_conv3x3_reference
    from ccst_tpu_torch.models import vgg

    g = torch.Generator().manual_seed(1)
    enc = vgg.init_params(vgg.ENCODER_ARCH, g)
    images = lambda n: torch.rand((n, size, size, 3), generator=g).to(dev)  # noqa: E731
    content, style, inv = images(8), images(8), images(16)
    k32, k16 = (vgg.prepare_params(enc, dt, dev) for dt in (torch.float32, torch.bfloat16))
    a32, a16 = (vgg.trainable_params(enc, dev, dt, requires_grad=False)
                for dt in (torch.float32, torch.bfloat16))
    inv16 = inv.to(torch.bfloat16)

    def plain(fn):
        def run():
            real = vgg.reflect_conv3x3
            vgg.reflect_conv3x3 = lambda x, cw, relu=True: reflect_conv3x3_reference(
                x, cw.w, cw.b, relu)
            try:
                return fn()
            finally:
                vgg.reflect_conv3x3 = real
        return run

    def decoder(k, route):
        return lambda: (vgg.encoder_taps(k, style, route=route),
                        vgg.apply_encoder(k, content, route=route))

    def inverter(k16_, k32_, route):
        return lambda: (vgg.apply_encoder(k16_, inv16, route=route),
                        vgg.encoder_taps(k32_, inv, route=route))

    return {"train-decoder": {"k3": decoder(k32, "kernel"), "cudnn": decoder(a32, "autograd"),
                              "plain": plain(decoder(k32, "kernel"))},
            "invert-train": {"k3": inverter(k16, k32, "kernel"),
                             "cudnn": inverter(a16, a32, "autograd"),
                             "plain": plain(inverter(k16, k32, "kernel"))}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5, help="steps a timed run, and traced")
    ap.add_argument("--runs", type=int, default=3, help="timed runs (the median is kept)")
    ap.add_argument("--warmup", type=int, default=2, help="steps before the timed runs")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ccst_tpu_torch.benchmarks import card

    on_cuda = args.device == "cuda"
    if on_cuda and not torch.cuda.is_available():
        print("privacy_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0) if on_cuda else torch.device("cpu")
    info = card(dev)
    print(info.get("nvidia_smi", info["device"]), flush=True)

    def timed(fn) -> float:
        for _ in range(args.warmup):
            fn()
        times = []
        for _ in range(args.runs):
            if on_cuda:
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                for _ in range(args.steps):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end) / args.steps)
            else:
                t0 = time.perf_counter()
                for _ in range(args.steps):
                    fn()
                times.append((time.perf_counter() - t0) * 1e3 / args.steps)
        return sorted(times)[len(times) // 2]

    steps = make_steps(dev, args.size)
    result = {"card": info, "torch": torch.__version__, "size": args.size,
              "precision": "float32, TF32 off; K3 bf16 for the style vector", "cases": {}}
    for case in CASES:
        fn, n_images = steps[case]
        if on_cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        step_ms = timed(fn)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            for _ in range(args.steps):
                fn()
            if on_cuda:
                torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        by_family = defaultdict(float)
        by_name = defaultdict(lambda: [0.0, 0])
        for evt in prof.events():
            if evt.device_type != DeviceType.CUDA:
                continue
            us = evt.time_range.elapsed_us()
            by_family[family(evt.name)] += us / 1e3 / args.steps
            by_name[evt.name][0] += us / 1e3 / args.steps
            by_name[evt.name][1] += 1 / args.steps
        busy = sum(by_family.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        row = {"step_ms": step_ms, "steps_per_sec": 1e3 / step_ms,
               "img_per_sec": n_images / (step_ms * 1e-3), "batch": n_images,
               "traced_wall_ms_a_step": traced_ms,
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if on_cuda else None,
               "device_ms_a_step": busy if on_cuda else None,
               "idle_share": (1 - busy / step_ms) if on_cuda else None,
               "family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1]))
               if on_cuda else None,
               "kernels": [{"name": n[:120], "ms": ms, "launches": c} for n, (ms, c) in top]
               if on_cuda else [],
               "launches_a_step": sum(c for _, c in by_name.values()) if on_cuda else None}
        if on_cuda and busy == 0:
            row["note"] = "the profiler saw no device kernel: no device split"
        result["cases"][case] = row
        print(f"{case}: {step_ms:.2f} ms a step, {row['img_per_sec']:.1f} img/s"
              + (f", device busy {busy:.2f} ms, idle {100 * row['idle_share']:.1f}%"
                 if on_cuda else ""), flush=True)
    from ccst_tpu_torch.utils.precision import no_tf32

    result["frozen_passes"] = {}
    with torch.no_grad(), no_tf32():
        for case, routes in frozen_passes(dev, args.size).items():
            row = {f"{route}_ms": timed(fn) for route, fn in routes.items()}
            result["frozen_passes"][case] = row
            print(f"{case} grad-free passes (18 convs): K3 {row['k3_ms']:.3f} ms, cuDNN "
                  f"{row['cudnn_ms']:.3f} ms, plain {row['plain_ms']:.3f} ms", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
