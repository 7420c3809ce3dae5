"""ctypes bindings for the native IO library (GIL-free decode/resize/encode).

Falls back gracefully: if ``libccst_io.so`` is absent, an automatic
``make``-based build is attempted once; if that fails (no toolchain), callers
get ``available() == False`` and use the PIL path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libccst_io.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _HERE, "libccst_io.so"],
            check=True,
            capture_output=True,
        )
        return os.path.exists(_SO)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.ccst_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
        ]
        lib.ccst_decode_resize.restype = ctypes.c_int
        lib.ccst_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ccst_decode_resize_batch.restype = ctypes.c_int
        lib.ccst_encode_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.ccst_encode_png.restype = ctypes.c_int
        lib.ccst_encode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.ccst_encode_jpeg.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_resize(path: str, size: int) -> np.ndarray:
    """One image -> (size, size, 3) float32 in [0, 1]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    out = np.empty((size, size, 3), np.float32)
    rc = lib.ccst_decode_resize(
        path.encode(), size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    )
    if rc:
        raise IOError(f"native decode failed: {path}")
    return out


def decode_resize_batch(
    paths: Sequence[str], size: int, n_threads: int = 8
) -> np.ndarray:
    """Thread-pooled batch decode -> (N, size, size, 3) float32."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    n = len(paths)
    out = np.empty((n, size, size, 3), np.float32)
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.ccst_decode_resize_batch(
        arr, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if failures:
        bad = [paths[i] for i in np.nonzero(status)[0][:3]]
        raise IOError(f"native decode failed for {failures} images, e.g. {bad}")
    return out


def encode_png(path: str, rgb_u8: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    if rgb_u8.dtype != np.uint8 or rgb_u8.ndim != 3 or rgb_u8.shape[2] != 3:
        raise ValueError("expected (H, W, 3) uint8")
    rgb_u8 = np.ascontiguousarray(rgb_u8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rc = lib.ccst_encode_png(
        path.encode(),
        rgb_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        rgb_u8.shape[0],
        rgb_u8.shape[1],
    )
    if rc:
        raise IOError(f"native png encode failed: {path}")


def encode_jpeg(path: str, rgb_u8: np.ndarray, quality: int = 92) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    if rgb_u8.dtype != np.uint8 or rgb_u8.ndim != 3 or rgb_u8.shape[2] != 3:
        raise ValueError("expected (H, W, 3) uint8")
    rgb_u8 = np.ascontiguousarray(rgb_u8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rc = lib.ccst_encode_jpeg(
        path.encode(),
        rgb_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        rgb_u8.shape[0],
        rgb_u8.shape[1],
        quality,
    )
    if rc:
        raise IOError(f"native jpeg encode failed: {path}")
