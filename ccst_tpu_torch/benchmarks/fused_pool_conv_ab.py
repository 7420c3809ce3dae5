"""B3: does fusing pool1 into conv2_1 pay on this card?

Counterpart of ``benchmarks/fused_pool_conv_ab.py``. Variants, all with the
same int32 accumulation and float32 requant epilogue:

  A    production: ``phase_max`` (plain torch) -> conv2_1 (K0, reflect)
  F9   ``kernels/pool_conv.py::pool_conv_fused``, 9 K-steps of 64 (a tap a weight stage)
  F3   the same kernel, 3 K-steps of 192 (the column taps of a kernel row a stage)

Keys: ``correctness`` (F9 and F3 against A at (2, 16, 16, 256), as the
reference's ``check_correctness``), ``A_pool1_c21_ms``, ``F9_fused_ms``,
``F3_fused_ms``, ``delta_ms`` (A minus the faster fused variant), and
``exact_vs_production`` (both fused outputs equal A's at the timed shape). The
reference's ``projected_img_per_sec_if_fused`` rested on a TPU step time and
is not reported.

    python -m ccst_tpu_torch.benchmarks.fused_pool_conv_ab            # B = 128
    python -m ccst_tpu_torch.benchmarks.fused_pool_conv_ab --device cpu --batch 1 --spatial 8
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from ccst_tpu_torch import benchmarks as bm
from ccst_tpu_torch.kernels.level1 import phase_max
from ccst_tpu_torch.kernels.pool_conv import pool_conv_fused, prepare_pool_conv
from ccst_tpu_torch.kernels.qconv import make_qconv, qconv3x3_s8
from ccst_tpu_torch.models.vgg_fast import _quantize_kernel

B = 128
CHECK_SHAPE = (2, 16, 16, 256)
VARIANTS = (("F9", False), ("F3", True))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--spatial", type=int, default=256, help="packed plane side (Hb = Wb)")
    bm.add_common_args(ap)
    return ap.parse_args(argv)


def planned_launches(args) -> dict:
    """The correctness check (A once, F9 and F3 once each), the timed shape's
    comparison (the same), then one timing of each variant."""
    t = bm.calls_per_timing(args)
    return {"qconv3x3_s8": 2 + t, "pool_conv_fused": 2 * len(VARIANTS) + len(VARIANTS) * t}


def build_prep(w=None, b=None):
    """conv2_1's int8 weights and epilogue terms as the reference builds them:
    weights (3, 3, 64, 128) and bias drawn from seed 0 with numpy
    (Kaiming-uniform bounds, as ``vgg.init_params``) unless given, quantized
    per output channel, input scale 11/127, output scale 9/127. Returns (wq, k,
    kb) as numpy arrays."""
    if w is None:
        rng = np.random.default_rng(0)
        bound = math.sqrt(1.0 / (9 * 64))
        w = rng.uniform(-bound, bound, (3, 3, 64, 128)).astype(np.float32)
        b = rng.uniform(-bound, bound, (128,)).astype(np.float32)
    wq, ws = _quantize_kernel(np.asarray(w, np.float32))
    in_s, out_s = 11.0 / 127.0, 9.0 / 127.0
    k = np.asarray(ws, np.float32) * in_s / out_s
    kb = np.asarray(b, np.float32) / out_s
    return wq, k, kb


def production(xp: torch.Tensor, q) -> torch.Tensor:
    """Variant A: the unfused chain the int8 engines run."""
    return qconv3x3_s8(phase_max(xp, 64), q, True, torch.int8, "reflect")


def _input(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-5, 120, shape, generator=gen, device=dev, dtype=torch.int8)


def check_correctness(q, wp, dev) -> dict:
    """F9 and F3 against A, bit for bit, at a small shape."""
    xp = _input(CHECK_SHAPE, 1, dev)
    want = production(xp, q)
    ok = {}
    for name, cat in VARIANTS:
        bm.check_equal(f"{name} vs production", pool_conv_fused(xp, q, cat, wp), want)
        ok[name] = "bit-exact"
    return ok


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = bm.device_of(args)
    wq, k, kb = build_prep()
    q = make_qconv(wq, k, kb, False, True, dev)
    wp = prepare_pool_conv(q)  # the fused kernel's stage tiles, packed once
    res = {**bm.card(dev), "correctness": check_correctness(q, wp, dev)}
    print(json.dumps(res), flush=True)

    xp = _input((args.batch, args.spatial, args.spatial, 256), 0, dev)
    res["shape"] = list(xp.shape)
    want = production(xp, q)
    for name, cat in VARIANTS:
        bm.check_equal(f"{name} vs production at {tuple(xp.shape)}",
                       pool_conv_fused(xp, q, cat, wp), want)
    res["exact_vs_production"] = True
    del want
    if dev.type == "cuda":
        res["A_pool1_c21_ms"] = bm.time_ms(lambda: production(xp, q), args)
        for name, cat in VARIANTS:
            res[f"{name}_fused_ms"] = bm.time_ms(lambda c=cat: pool_conv_fused(xp, q, c, wp), args)
        res["delta_ms"] = res["A_pool1_c21_ms"] - min(res["F9_fused_ms"], res["F3_fused_ms"])
        ops = 2 * xp.shape[0] * xp.shape[1] * xp.shape[2] * 576 * 128
        for name in ("A_pool1_c21", "F9_fused", "F3_fused"):
            res[f"{name}_tops"] = ops / (res[f"{name}_ms"] * 1e-3) / 1e12
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
