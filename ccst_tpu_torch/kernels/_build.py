"""Build and load the package's CUDA kernels (``ccst_tpu_torch/csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` to an object file, all of
them at once in parallel processes, and the objects are linked into one shared
library with a plain C interface, bound through ``ctypes``. The library is
built at first use, named by a hash of the sources, the headers and the flags,
under ``ccst_tpu_torch/_build/`` (listed in ``.gitignore``); a later call in the
same checkout reuses it. Only sources in this repository and the CUDA toolkit
are used. A failed build raises with the compiler's output.

WCT's kernels (``csrc/wct/``) are a library of their own, ``library("wct")``:
built and loaded only by a run that stylizes with WCT, so that they cost the
AdaIN paths nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: pointers and the stream as c_void_p, ints as c_int
SIGNATURES = {
    # x, wp, bias, y, N, H, W, Cin, Cout, relu, reflect, stream
    "ccst_reflect_conv3x3_bf16": [_P] * 4 + [_I] * 7 + [_P],
    "ccst_reflect_conv3x3_f32": [_P] * 4 + [_I] * 7 + [_P],
    # x, y, s_mean, s_std, N, HW, C, S, cluster, rows_per_block, resident, is_f32,
    # alpha, eps, n_var, stream
    "ccst_adain": [_P] * 4 + [_I] * 8 + [_F] * 3 + [_P],
    # x, y, mean, inv_std, s_mean, s_std, rows, HW, C, S, is_f32, alpha, stream
    "ccst_adain_given": [_P] * 6 + [_L] + [_I] * 4 + [_F] + [_P],
    # x, partials, out, tickets, R, C, chunk, is_f32, stream
    "ccst_channel_moments": [_P] * 4 + [_L] + [_I] * 3 + [_P],
    # stream
    "ccst_empty_launch": [_P],
    # x, wp, k, kb, y, N, H, W, Cin, Cout, reflect, relu, out_kind, row_shift, stream
    "ccst_qconv3x3_s8": [_P] * 5 + [_I] * 9 + [_P],
    # x, w1, k1, kb1, w2, k2, kb2, y, N, Hb, Wb, Cin, Cout, pool, stream
    "ccst_fused_two_conv_s8": [_P] * 8 + [_I] * 6 + [_P],
    # x, wp, y, M, N, K, kind, stream
    "ccst_tiled_mm": [_P] * 3 + [_I] * 4 + [_P],
    # x, up, k, kb, y, N, Hb, Wb, Cin, Cout, mode, stream
    "ccst_winograd_s8": [_P] * 5 + [_I] * 6 + [_P],
    # xp, wp, k, kb, y, N, Hb, Wb, Cout, cat, stream
    "ccst_pool_conv_s8": [_P] * 5 + [_I] * 5 + [_P],
}
WCT_SIGNATURES = {
    # x, mean, hi, lo, B, P, C, is_f32, stream
    "ccst_wct_centre_split": [_P] * 4 + [_L] * 2 + [_I] * 2 + [_P],
}
# library -> its C entry points; a part's sources are csrc/<part>/, the main
# library's csrc/ itself
PARTS = {"": SIGNATURES, "wct": WCT_SIGNATURES}

_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _folder(part: str) -> Path:
    return CSRC / part if part else CSRC


def _sources(part: str = ""):
    return sorted(_folder(part).glob("*.cu"))


def library_path(part: str = "") -> Path:
    """Path of the library for the current sources (built or not)."""
    folder = _folder(part)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*folder.glob("*.cu"), *folder.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    name = f"ccst_{part}_kernels" if part else "ccst_kernels"
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(out: Path, part: str = "") -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = _sources(part)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                  for src, obj in zip(sources, objs)])
        tmp = os.path.join(tmpdir, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def library(part: str = "") -> ctypes.CDLL:
    """The loaded kernel library (``part`` names one of :data:`PARTS`),
    compiling it first if needed."""
    with _lock:
        if part not in _libs:
            path = library_path(part)
            if not path.exists():
                _compile(path, part)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in PARTS[part].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[part] = lib
        return _libs[part]
