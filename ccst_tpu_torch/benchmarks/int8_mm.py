"""B1: does a hand-written tiled GEMM reach the tensor cores' int8 (and bf16)
rate on this card, and how far is it from cuBLAS?

Counterpart of ``benchmarks/pallas_int8_mxu.py``: the same shape sweep (M =
2^18, (K, N) over the int8 engines' conv GEMM shapes) and the same three
variants, int8 -> int32, int8 -> float32 and bf16 -> float32, of
``kernels/int8_mm.py::tiled_mm``. One JSON line per shape, the results so far:

  kernel_{i8i32,i8f32,bf16}_{K}x{N}     the kernel's TOPS (TFLOP/s for bf16)
  peak_share_{...}_{K}x{N}              of the 1,979 int8 / 989 bf16 dense peak
  bound_share_{...}_{K}x{N}             of the least time the card could take:
                                        the larger of the operations at that
                                        peak and the bytes (x, w once in, y
                                        once out) at 3.35 TB/s; at these shapes
                                        it is the bytes
  cublas_{i8i32,bf16}_{K}x{N}           ``torch._int_mm`` and ``torch.mm(x, w,
                                        out_dtype=torch.float32)``, the library
                                        calls for the same functions, timed for
                                        comparison only (they are not the port)

Each kernel's first 1024 rows are held to its plain version bit for bit first.

    python -m ccst_tpu_torch.benchmarks.int8_mm
    python -m ccst_tpu_torch.benchmarks.int8_mm --device cpu --m 256 --shapes 64x32
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ccst_tpu_torch import benchmarks as bm
from ccst_tpu_torch.kernels.int8_mm import prepare_mm_weight, tiled_mm, tiled_mm_reference

SHAPES = "256x256,512x512,2304x256,576x256,1152x128"
VARIANTS = (("i8i32", torch.int8, torch.int32), ("i8f32", torch.int8, torch.float32),
            ("bf16", torch.bfloat16, torch.float32))
CHECK_ROWS = 1024


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1 << 18)
    ap.add_argument("--shapes", default=SHAPES, help="comma-separated KxN")
    bm.add_common_args(ap)
    return ap.parse_args(argv)


def _shapes(args):
    return [tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")]


def planned_launches(args) -> dict:
    """Per shape and variant: one checked call, then one timing."""
    return {"tiled_mm": len(_shapes(args)) * len(VARIANTS) * (1 + bm.calls_per_timing(args))}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = bm.device_of(args)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {**bm.card(dev), "m": args.m}
    for k, n in _shapes(args):
        xi = torch.randint(-127, 127, (args.m, k), generator=gen, device=dev, dtype=torch.int8)
        wi = torch.randint(-127, 127, (k, n), generator=gen, device=dev, dtype=torch.int8)
        ops = 2 * args.m * k * n
        for name, in_dtype, out_dtype in VARIANTS:
            x, w = xi.to(in_dtype), wi.to(in_dtype)
            mw = prepare_mm_weight(w)
            rows = min(CHECK_ROWS, args.m)
            got = tiled_mm(x, mw, out_dtype)
            bm.check_equal(f"tiled_mm {name} {k}x{n}", got[:rows],
                           tiled_mm_reference(x[:rows], w, out_dtype))
            if dev.type != "cuda":
                continue
            peak = bm.BF16_PEAK_TFLOPS if name == "bf16" else bm.INT8_PEAK_TOPS
            ms = bm.time_ms(lambda: tiled_mm(x, mw, out_dtype), args)
            tops = ops / (ms * 1e-3) / 1e12
            nbytes = (x.numel() + w.numel()) * x.element_size() + 4 * args.m * n
            res[f"kernel_{name}_{k}x{n}"] = tops
            res[f"peak_share_{name}_{k}x{n}"] = tops / peak
            res[f"bound_share_{name}_{k}x{n}"] = max(ops / (peak * 1e9),
                                                      nbytes / (bm.HBM_TB_S * 1e9)) / ms
            if name == "i8f32":
                continue
            lib = ((lambda: torch._int_mm(x, w)) if name == "i8i32"
                   else (lambda: torch.mm(x, w, out_dtype=torch.float32)))
            res[f"cublas_{name}_{k}x{n}"] = ops / (bm.time_ms(lib, args) * 1e-3) / 1e12
        res[f"exact_{k}x{n}"] = True
        print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
