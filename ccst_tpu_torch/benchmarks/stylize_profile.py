"""Where the stylize stage's time goes: disk-to-disk rates through the CLI, and
a device trace of one batch per engine.

    python -m ccst_tpu_torch.benchmarks.stylize_profile \
        [--images-per-domain 512] [--batch-size 32] [--size 512] \
        [--profile-batch 4] [--calls 5] [--device cuda|cpu]

On a synthetic PACS tree (four domains of seeded blocky-noise PNGs) with
seeded random VGG-19 / decoder weights it

  1. runs ``style-bank`` and ``calibrate`` once, then ``stylize --target
     photo`` through ``cli.main`` for each of :data:`CLI_RUNS` (Overall with
     ``ref``, ``packed``, ``int8``, ``int8-fused``; Single with ``ref`` and
     ``int8-fused``; Overall ``ref`` again, to see the drift), and keeps each
     run's timing JSON (``images_per_sec`` and the waits). A run's outputs are
     deleted after it, so the disk holds one run's PNGs at a time;
  2. for each engine, times ``stylize_multi`` on one ``--profile-batch`` batch
     of the tree's photos at three styles (CUDA events around a loop of
     calls), then traces ``--calls`` calls with ``torch.profiler``: device time
     a call by kernel (K0, K1, K2, K3, K4, K5 by their kernel names; every other
     kernel is PyTorch's glue, listed by name), the glue that
     ``vgg_fast._quantize_act`` launches (a ``record_function`` range around
     it), and the device's idle share (1 - kernel time / call time).

Prints the card's name and power limit, then one JSON object as the last line.
``--device cpu`` runs the same steps through the plain versions at the sizes
given (use tiny ones): host times only, no device number.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time
from collections import defaultdict

DOMAINS = ("art_painting", "cartoon", "photo", "sketch")
DEC_SCALE, DEC_SHIFT = 12.0, 0.5  # last decoder conv: outputs spread over [0, 1]
# (name, --mode, --engine) of each disk-to-disk run, in order
CLI_RUNS = (
    ("overall ref", "overall", "ref"),
    ("overall packed", "overall", "packed"),
    ("overall int8", "overall", "int8"),
    ("overall int8-fused", "overall", "int8-fused"),
    ("single ref", "single", "ref"),
    ("single int8-fused", "single", "int8-fused"),
    ("overall ref, again", "overall", "ref"),
)
PROFILE_ENGINES = ("ref", "packed", "int8", "int8-fused")
# kernel-name fragment -> the port's kernel id; every other device kernel is glue
KERNEL_IDS = (("qconv3x3_s8", "K0"), ("encoder_level1", "K1"), ("decoder_level1", "K2"),
              ("reflect_conv3x3", "K3"), ("adain_kernel", "K4"), ("channel_moments", "K5"))
QUANTIZE_RANGE = "ccst::quantize_act"


def write_tree(root: str, images_per_domain: int, size: int) -> None:
    """``PACS/kfold/{domain}/dog/img{i}.png`` (blocky seeded noise, ``size`` px)
    and ``txt_lists/pacs/{domain}_train.txt`` lines ``<rel> <i mod 7>`` (the
    labels spread over PACS's 7 classes for the training stage)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    block = max(size // 32, 1)
    for d in DOMAINS:
        rels = []
        for i in range(images_per_domain):
            rel = f"PACS/kfold/{d}/dog/img{i}.png"
            base = rng.random((-(-size // block), -(-size // block), 3), dtype=np.float32)
            img = np.kron(base, np.ones((block, block, 1), np.float32))[:size, :size]
            img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1) * 255 + 0.5
            os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
            Image.fromarray(img.astype(np.uint8)).save(os.path.join(root, rel), compress_level=1)
            rels.append(rel)
        list_path = os.path.join(root, "txt_lists", "pacs", f"{d}_train.txt")
        os.makedirs(os.path.dirname(list_path), exist_ok=True)
        with open(list_path, "w") as f:
            f.writelines(f"{rel} {i % 7}\n" for i, rel in enumerate(rels))


def run_cli(cli, argv) -> str:
    """``cli.main(argv)`` with its output captured; raises on a non-zero exit."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise SystemExit(f"stylize_profile: {argv[0]} returned {rc}:\n{out.getvalue()}")
    return out.getvalue()


def cli_rates(cli, root: str, common, args) -> dict:
    """Step 1: the bank and calibration once, then every run of :data:`CLI_RUNS`."""
    t0 = time.perf_counter()
    run_cli(cli, ["style-bank", *common(root)])
    run_cli(cli, ["calibrate", *common(root), "--target", "photo", "--engine", "int8-fused"])
    rates = {"setup_seconds": time.perf_counter() - t0}
    for name, mode, engine in CLI_RUNS:
        out_root = os.path.join(root, "runs", name.replace(" ", "_").replace(",", ""))
        t0 = time.perf_counter()
        run_cli(cli, ["stylize", *common(out_root), "--target", "photo", "--mode", mode,
                      "--engine", engine])
        wall = time.perf_counter() - t0
        with open(os.path.join(out_root, f"pacs_photo_{mode}_stylize_time.json")) as f:
            timing = json.load(f)
        shutil.rmtree(out_root)
        rates[name] = {**timing, "cli_wall_seconds": wall}
        print(f"{name}: {timing['images_per_sec']} img/s disk to disk "
              f"({timing['images_per_style']} images a style; the call {wall:.3f} s)", flush=True)
    return rates


def profile_engine(torch, eng, images, s_means, s_stds, calls: int, on_cuda: bool) -> dict:
    """Step 2 for one engine: a loop of ``calls`` calls timed, then traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ccst_tpu_torch.models import vgg_fast

    call = lambda: eng.stylize_multi(images, s_means, s_stds, 1.0)
    for _ in range(2):
        call()
    if on_cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call()
        end.record()
        torch.cuda.synchronize()
        call_ms = start.elapsed_time(end) / calls
    else:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        call_ms = (time.perf_counter() - t0) * 1e3 / calls

    quantize = vgg_fast._quantize_act

    def traced_quantize(x):
        with record_function(QUANTIZE_RANGE):
            return quantize(x)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    vgg_fast._quantize_act = traced_quantize
    try:
        with profile(activities=activities) as prof:
            for _ in range(calls):
                call()
            if on_cuda:
                torch.cuda.synchronize()
    finally:
        vgg_fast._quantize_act = quantize

    by_id = defaultdict(float)
    glue = defaultdict(lambda: [0.0, 0])
    quantize_us = 0.0
    for evt in prof.events():
        if evt.name == QUANTIZE_RANGE:  # the range, and its mark on the device's timeline
            if evt.device_type == DeviceType.CPU:
                quantize_us += evt.device_time_total  # its kernels and its children's
            continue
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        kid = next((k for frag, k in KERNEL_IDS if frag in evt.name), None)
        if kid:
            by_id[kid] += us
        else:
            glue[evt.name][0] += us
            glue[evt.name][1] += 1
    kernels_ms = {k: v / 1e3 / calls for k, v in sorted(by_id.items())}
    glue_ms = sum(v[0] for v in glue.values()) / 1e3 / calls
    busy_ms = sum(kernels_ms.values()) + glue_ms
    top = sorted(glue.items(), key=lambda kv: -kv[1][0])[:12]
    result = {
        "call_ms": call_ms,
        "traced_calls": calls,
        "device_ms": busy_ms if on_cuda else None,
        "idle_share": (1 - busy_ms / call_ms) if on_cuda else None,
        "kernels_ms": kernels_ms if on_cuda else None,
        "glue_ms": glue_ms if on_cuda else None,
        "quantize_glue_ms": quantize_us / 1e3 / calls if on_cuda else None,
        "glue_kernels": [{"name": n[:120], "ms": us / 1e3 / calls, "launches": c / calls}
                         for n, (us, c) in top] if on_cuda else [],
    }
    if on_cuda and busy_ms == 0:
        result["note"] = "the profiler saw no device kernel: no device split for this engine"
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images-per-domain", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--profile-batch", type=int, default=4)
    ap.add_argument("--calls", type=int, default=5, help="calls timed, then traced")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ccst_tpu_torch import cli
    from ccst_tpu_torch.benchmarks import card
    from ccst_tpu_torch.models import convert, vgg, vgg_fast
    from ccst_tpu_torch.pipeline.style_bank import load_style_stats
    from ccst_tpu_torch.pipeline.stylize import StylizeEngine

    on_cuda = args.device == "cuda"
    if on_cuda and not torch.cuda.is_available():
        print("stylize_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0) if on_cuda else torch.device("cpu")
    info = card(dev)
    print(info.get("nvidia_smi", info["device"]), flush=True)

    with tempfile.TemporaryDirectory(prefix="ccst_profile_") as root:
        t0 = time.perf_counter()
        write_tree(root, args.images_per_domain, args.size)
        tree_seconds = time.perf_counter() - t0
        enc = vgg.init_params(vgg.ENCODER_ARCH, torch.Generator().manual_seed(42))
        dec = vgg.init_params(vgg.DECODER_ARCH, torch.Generator().manual_seed(43))
        last = dec["dconv1_1"]
        last["w"], last["b"] = last["w"] * DEC_SCALE, last["b"] * DEC_SCALE + DEC_SHIFT
        enc_path, dec_path = os.path.join(root, "vgg.npz"), os.path.join(root, "decoder.npz")
        convert.save_npz(enc_path, enc)
        convert.save_npz(dec_path, dec)
        stats = os.path.join(root, "style_stats")

        def common(out_root):
            return ["--dataset", "pacs", "--list-root", root, "--data-root", root,
                    "--output-root", out_root, "--style-stats-dir", stats,
                    "--image-size", str(args.size), "--batch-size", str(args.batch_size),
                    "--dtype", "bfloat16", "--vgg-weights", enc_path,
                    "--decoder-weights", dec_path, "--device", args.device]

        rates = cli_rates(cli, root, common, args)

        from PIL import Image

        photos = [os.path.join(root, f"PACS/kfold/photo/dog/img{i}.png")
                  for i in range(args.profile_batch)]
        images = torch.from_numpy(np.stack([np.asarray(Image.open(p).convert("RGB"))
                                            for p in photos])).to(dev)
        banks = [load_style_stats(os.path.join(stats, "pacs", f"{d}_mean_std.npz"))
                 for d in DOMAINS if d != "photo"]
        s_means = torch.tensor(np.stack([m for m, _ in banks]), device=dev)
        s_stds = torch.tensor(np.stack([s for _, s in banks]), device=dev)
        scales = vgg_fast.load_scales(
            os.path.join(stats, "pacs", "photo_q8_scales.json"),
            expect_fingerprint=vgg_fast.weights_fingerprint(enc, dec))
        profiles = {}
        with torch.no_grad():
            for name in PROFILE_ENGINES:
                eng = StylizeEngine(enc, dec, dtype=torch.bfloat16, device=dev, engine=name,
                                    scales=scales)
                profiles[name] = profile_engine(torch, eng, images, s_means, s_stds, args.calls,
                                                on_cuda)
                print(f"{name}: " + json.dumps(profiles[name]), flush=True)
                del eng

    print(json.dumps({
        "card": info, "torch": torch.__version__, "size": args.size,
        "images_per_domain": args.images_per_domain, "batch_size": args.batch_size,
        "tree_seconds": tree_seconds, "cli": rates,
        "profile": {"batch": args.profile_batch, "styles": len(DOMAINS) - 1, **profiles},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
