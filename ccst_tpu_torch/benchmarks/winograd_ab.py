"""B2: does int8 Winograd F(2x2, 3x3) beat a direct int8 conv on this card?

Counterpart of ``benchmarks/winograd_ab.py``, with its arguments (the packed
conv1_2 shape: ``--batch 8 --spatial 256 --cin 256 --cout 256``), its seeded
inputs and weights, and its result keys:

  psnr_wino_vs_direct_db, mean_abs_lsb   Winograd's int8 output against the
                                         direct conv's (V carries 2 extra bits
                                         into a /4 shift)
  k0_ms         the port's production int8 conv (K0, ``qconv3x3_s8``, edge
                padding) at the same shape; the reference's ``xla_ms``
  direct_ms     ``kernels/winograd.py::conv_direct``: the same K0 kernel and
                weights with the reference's row offset
  wino_{full,dots,tf}_ms   ``conv_wino`` whole, without the transform
                (dots), without the products (tf)

The kernels' tiles are fixed at build time, so the reference's ``--ht/--wt``
are gone. Image 0's outputs of both kernels are held to their plain versions
bit for bit first.

    python -m ccst_tpu_torch.benchmarks.winograd_ab
    python -m ccst_tpu_torch.benchmarks.winograd_ab --device cpu --batch 1 --spatial 16 --cin 64 --cout 64
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from ccst_tpu_torch import benchmarks as bm
from ccst_tpu_torch.kernels.qconv import qconv3x3_s8
from ccst_tpu_torch.kernels.winograd import (
    MODES,
    conv_direct,
    conv_direct_reference,
    conv_wino,
    conv_wino_reference,
    make_wino_conv,
    wino_weights,
)
from ccst_tpu_torch.models.vgg_fast import _quantize_kernel


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--spatial", type=int, default=256)
    ap.add_argument("--cin", type=int, default=256)
    ap.add_argument("--cout", type=int, default=256)
    bm.add_common_args(ap)
    return ap.parse_args(argv)


def planned_launches(args) -> dict:
    """One direct and one Winograd call for the comparison, then the
    timings: K0 once, direct once, Winograd in each mode."""
    t = bm.calls_per_timing(args)
    return {"qconv3x3_s8": t, "conv_direct": 1 + t, "conv_wino": 1 + len(MODES) * t}


def build(args, dev):
    """The reference's inputs and weights, from its seed: x in [0, 100),
    w ~ N(0, 0.05) quantized per output channel, kb ~ N(0, 0.1)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, (args.batch, args.spatial, args.spatial, args.cin)).astype(np.int8)
    w = rng.normal(0, 0.05, (3, 3, args.cin, args.cout)).astype(np.float32)
    wq, ws = _quantize_kernel(w)
    in_s = 4.0 / 127.0  # input scale; output scale identical -> they cancel
    k_dir = np.asarray(ws, np.float32).reshape(-1) * in_s / (4.0 / 127.0)
    kb = rng.normal(0, 0.1, (args.cout,)).astype(np.float32)
    uq, su = wino_weights(wq)
    # the V /4 shift cancels the (2G)^2 = 4x in U, so k = su * ws here
    k_wino = np.asarray(su) * np.asarray(ws, np.float32).reshape(-1) * in_s / (4.0 / 127.0)
    return torch.from_numpy(x).to(dev), make_wino_conv(wq, uq, k_dir, k_wino, kb, dev)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = bm.device_of(args)
    x, conv = build(args, dev)
    out_d = conv_direct(x, conv)
    out_w = conv_wino(x, conv, "full")
    bm.check_equal("conv_direct image 0", out_d[:1], conv_direct_reference(x[:1], conv))
    bm.check_equal("conv_wino image 0", out_w[:1], conv_wino_reference(x[:1], conv, "full"))
    diff = out_d.double() - out_w.double()
    mse = float((diff ** 2).mean())
    result = {
        **bm.card(dev),
        "shape": list(x.shape),
        "cout": args.cout,
        "psnr_wino_vs_direct_db": 10 * math.log10(127.0 ** 2 / max(mse, 1e-12)),
        "mean_abs_lsb": float(diff.abs().mean()),
    }
    if dev.type == "cuda":
        ops = 2 * x.numel() * 9 * args.cout
        k0 = lambda: qconv3x3_s8(x, conv.direct, True, torch.int8, "edge")
        result["k0_ms"] = bm.time_ms(k0, args)
        result["direct_ms"] = bm.time_ms(lambda: conv_direct(x, conv), args)
        for mode in MODES:
            result[f"wino_{mode}_ms"] = bm.time_ms(lambda m=mode: conv_wino(x, conv, m), args)
        for key in ("k0", "direct", "wino_full"):
            # direct-conv operations per second (Winograd's are 2.25x fewer)
            result[f"{key}_tops"] = ops / (result[f"{key}_ms"] * 1e-3) / 1e12
    print(json.dumps(result, indent=2), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
