"""The port's int8 A/B harnesses, counterparts of the JAX project's
``benchmarks/pallas_int8_mxu.py``, ``winograd_ab.py`` and
``fused_pool_conv_ab.py``, each of which settled one int8 design question on
the TPU. Here they ask it of the H100::

    python -m ccst_tpu_torch.benchmarks.int8_mm            # B1: GEMM TOPS vs cuBLAS
    python -m ccst_tpu_torch.benchmarks.winograd_ab        # B2: Winograd vs direct vs K0
    python -m ccst_tpu_torch.benchmarks.fused_pool_conv_ab # B3: pool1+conv2_1 fused vs not

On ``--device cuda`` (the default) a harness checks its kernels against their
plain versions, times them with CUDA events and prints JSON with the card's
name and power limit. On ``--device cpu`` it runs the plain versions at the
shapes it is given (use tiny ones) and reports no time: a CPU run says nothing
of the card. Every harness's ``main(argv)`` returns its result dict, and its
``planned_launches(args)`` says how many kernel launches a cuda run makes.
"""
from __future__ import annotations

import argparse
import subprocess
from typing import Callable, Dict, Optional

import torch

# H100 SXM dense peaks (NVIDIA data sheet), at the 700 W power limit
INT8_PEAK_TOPS = 1979.0
BF16_PEAK_TFLOPS = 989.0
HBM_TB_S = 3.35  # device memory rate of the same data sheet


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=10, help="calls per timed run")
    ap.add_argument("--runs", type=int, default=5, help="timed runs (the median is kept)")


def device_of(args) -> torch.device:
    """The requested device; a cuda run without a card fails."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on a GPU, or pass --device cpu for the plain "
                         "versions at small shapes (no timing)")
    return torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")


def calls_per_timing(args) -> int:
    """Calls of the timed function in one :func:`time_ms`: a warm-up, then
    ``runs`` runs of ``reps``."""
    return 1 + args.reps * args.runs


def time_ms(fn: Callable[[], object], args) -> float:
    """Median over ``args.runs`` of the mean device time of ``args.reps``
    calls, after one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / args.reps)
    return sorted(times)[len(times) // 2]


def card(dev: torch.device) -> Dict[str, Optional[str]]:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if dev.type != "cuda":
        return {"device": "cpu", "timing": "not measured (plain versions on the CPU)"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i",
         str(dev.index or 0)],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi}


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Bit for bit, or raise."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        diff = (got.double() - want.double()).abs() if got.shape == want.shape else None
        detail = "" if diff is None else (f": {int((diff > 0).sum())} elements differ, "
                                          f"max abs err {diff.max().item():.3e}")
        raise AssertionError(f"{name}: kernel differs from its plain version{detail}")
