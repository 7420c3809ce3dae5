"""Where a training step's time goes: one local step of the federated runtime
and one eval step, timed, then traced.

    python -m ccst_tpu_torch.benchmarks.fed_profile \
        [--network resnet50] [--batch 32] [--size 222] [--steps 5] [--device cuda|cpu]

With seeded random weights (``init_weights``) and a seeded random uint8
batch, fedavg, float32 with TF32 off and cuDNN's deterministic algorithms
(the runner's numerics), it

  1. times ``--steps`` train steps and as many eval steps (CUDA events after
     two warm-up steps; the median of five runs);
  2. traces ``--steps`` train steps with ``torch.profiler``: device time a
     step by kernel family (convolutions, BatchNorm, elementwise and
     reductions, GEMMs, copies, the rest), the largest kernels by name, the
     traced steps' wall time a step, and the device's idle share (1 - kernel
     time / step time).

Prints the card's name and power limit, then one JSON object as the last line.
``--device cpu`` runs the same steps at the sizes given (use tiny ones): host
times only, no device number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

# kernel-name fragments -> family, first match wins
FAMILIES = (
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("conv", ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop", "winograd", "xmma")),
    ("gemm", ("gemm", "gemv", "cublas", "sm90_", "splitk")),
    ("copy", ("copy", "memcpy", "memset", "fill")),
    ("elementwise / reduce", ("elementwise", "reduce", "vectorized", "unrolled", "softmax",
                              "max_pool", "avg_pool", "index", "cat", "sort", "scatter",
                              "gather", "where", "clamp")),
)


def family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, frags in FAMILIES if any(f in low for f in frags)), "other")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="resnet50")
    ap.add_argument("--classes", type=int, default=7)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=222)
    ap.add_argument("--steps", type=int, default=5, help="steps a timed run, and traced")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ccst_tpu_torch.benchmarks import card
    from ccst_tpu_torch.federated.train_ops import make_eval_step, make_train_step
    from ccst_tpu_torch.models.classifiers import get_network, init_weights
    from ccst_tpu_torch.utils.precision import no_tf32

    on_cuda = args.device == "cuda"
    if on_cuda and not torch.cuda.is_available():
        print("fed_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0) if on_cuda else torch.device("cpu")
    info = card(dev)
    print(info.get("nvidia_smi", info["device"]), flush=True)

    model = init_weights(get_network(args.network, args.classes),
                         torch.Generator().manual_seed(0)).to(dev)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy(rng.integers(0, 256, (args.batch, args.size, args.size, 3), np.uint8))
    batch = {"images": u8.to(dev).float() / torch.full((), 255.0, device=dev),
             "labels": torch.from_numpy(rng.integers(0, args.classes, args.batch)).to(dev),
             "mask": torch.ones(args.batch, device=dev)}
    step = make_train_step(model, n_classes=args.classes, image_size=args.size, lr=1e-2)
    evaluate = make_eval_step(model, image_size=args.size)
    gen = torch.Generator().manual_seed(0)
    holder = [state]

    def train():
        holder[0], _ = step(holder[0], state, batch, gen, 0)

    def timed(fn) -> float:
        """ms a call: median of five runs of ``--steps`` calls (device time on
        the card, the host's clock on the CPU)."""
        for _ in range(2):
            fn()
        times = []
        for _ in range(5):
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

    with no_tf32(deterministic=True):
        if on_cuda:
            torch.cuda.reset_peak_memory_stats()
        step_ms = timed(train)
        eval_ms = timed(lambda: evaluate(holder[0], batch))
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            for _ in range(args.steps):
                train()
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
    busy_ms = sum(by_family.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    result = {
        "card": info, "torch": torch.__version__, "network": args.network,
        "batch": args.batch, "size": args.size,
        "precision": "float32, TF32 off, cuDNN deterministic",
        "step_ms": step_ms, "train_img_s": args.batch / (step_ms * 1e-3),
        "eval_ms": eval_ms, "eval_img_s": args.batch / (eval_ms * 1e-3),
        "traced_steps": args.steps, "traced_wall_ms_a_step": traced_ms,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated() if on_cuda else None,
        "device_ms_a_step": busy_ms if on_cuda else None,
        "idle_share": (1 - busy_ms / step_ms) if on_cuda else None,
        "family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])) if on_cuda else None,
        "kernels": [{"name": n[:120], "ms": ms, "launches": c} for n, (ms, c) in top]
        if on_cuda else [],
        "launches_a_step": sum(c for _, c in by_name.values()) if on_cuda else None,
    }
    if on_cuda and busy_ms == 0:
        result["note"] = "the profiler saw no device kernel: no device split"
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
