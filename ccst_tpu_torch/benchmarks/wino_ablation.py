"""Where the Winograd kernel's time goes (B2, ``csrc/winograd_s8.cu``): the
kernel against copies of itself built without the int32 adds of ``A^T M A``,
without the ``wgmma`` products, and without both.

    python -m ccst_tpu_torch.benchmarks.wino_ablation [--rounds 2]

Each copy is the repository's source with those statements cut out, compiled
alone with the flags of ``kernels/_build.py``; a copy's output is not the
conv, only its time is read. The repository's kernel is held to the plain
version bit for bit first. Then every variant in ``full`` and ``dots`` mode,
and K0 at the same shape, is timed from a replayed CUDA graph, ``--rounds``
times in turn, on the A/B harness's inputs (8, 256, 256, 256 -> 256). Prints
the card's name and power limit, one line a timing, then one JSON object.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

# the statements each variant cuts out of the kernel's source
ADDS = ("add_row(i, 0, sc[0], 1);", "add_row(i, 1, sc[1], 1);", "add_row(i, 1, sc[0], -1);")
PRODUCT = ("      Wgmma<false, 64>::mma(d, desc_at(a_str, sV + p * V_POS + ks * 2 * V_GROUP),\n"
           "                            desc_at(b_str, b_at + ks * 2 * WN * 16), accumulate | ks);")
VARIANTS = {"kernel": (), "no-adds": ADDS, "no-products": (PRODUCT,), "neither": (*ADDS, PRODUCT)}


def variant_source(source: str, name: str) -> str:
    """The kernel's source with variant ``name``'s statements replaced by
    empty ones (a loop body stays a statement); raises if the source no
    longer holds one of them."""
    for cut in VARIANTS[name]:
        if cut not in source:
            raise ValueError(f"csrc/winograd_s8.cu no longer holds {cut.strip()!r}")
        source = source.replace(cut, ";")
    return source


def _compile_variant(name: str, source: str, tmp: Path):
    from ccst_tpu_torch.kernels import _build as build

    for header in build.CSRC.glob("*.cuh"):
        (tmp / header.name).write_text(header.read_text())
    src, lib = tmp / f"wino_{name}.cu", tmp / f"libwino_{name}.so"
    src.write_text(variant_source(source, name))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).ccst_winograd_s8
    fn.argtypes, fn.restype = build.SIGNATURES["ccst_winograd_s8"], ctypes.c_int
    return fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    from ccst_tpu_torch import benchmarks as bm
    from ccst_tpu_torch.benchmarks import winograd_ab
    from ccst_tpu_torch.benchmarks.small_kernels import graph_ms
    from ccst_tpu_torch.kernels import _build as build
    from ccst_tpu_torch.kernels import winograd as wg
    from ccst_tpu_torch.kernels.qconv import qconv3x3_s8

    dev = bm.device_of(argparse.Namespace(device="cuda"))
    print(bm.card(dev)["nvidia_smi"], flush=True)
    source = (build.CSRC / "winograd_s8.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        fns = {name: _compile_variant(name, source, Path(tmp)) for name in VARIANTS}
        x, conv = winograd_ab.build(winograd_ab.parse_args([]), dev)
        n, h, w, cin = x.shape
        cout = conv.u.shape[2]
        y = torch.empty((n, h, w, cout), dtype=torch.int8, device=dev)

        def run(fn, mode):
            rc = fn(x.data_ptr(), conv.up.data_ptr(), conv.k_wino.data_ptr(), conv.kb.data_ptr(),
                    y.data_ptr(), n, h, w, cin, cout, wg.MODES.index(mode),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"Winograd launch failed: CUDA error {rc}")

        run(fns["kernel"], "full")
        bm.check_equal("the kernel, full", y, wg.conv_wino_reference(x, conv, "full"))
        times = {}
        for rnd in range(args.rounds):
            for name, fn in fns.items():
                for mode in ("full", "dots"):
                    ms = graph_ms(torch, lambda f=fn, m=mode: run(f, m), 10, 5)["median"]
                    times.setdefault(f"{name} {mode}", []).append(ms)
                    print(f"round {rnd} {name} {mode}: {ms:.4f} ms", flush=True)
            ms = graph_ms(torch, lambda: qconv3x3_s8(x, conv.direct, True, torch.int8, "edge"), 10,
                          5)["median"]
            times.setdefault("K0", []).append(ms)
            print(f"round {rnd} K0: {ms:.4f} ms", flush=True)
    result = {"shape": [n, h, w, cin, cout], "ms": times,
              "median_ms": {k: float(np.median(v)) for k, v in times.items()}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
