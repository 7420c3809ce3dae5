"""ctypes bindings for the native IO library (GIL-free decode/resize/encode).

Falls back gracefully: if ``libccst_io.so`` is absent, an automatic
``make``-based build is attempted once; if that fails (no toolchain), callers
get ``available() == False`` and use the PIL path.

Several processes may start on a fresh tree at once (the test workers, one
CLI process per domain). The build therefore runs under an exclusive
``fcntl`` lock on a file beside the library, into a name of its own, and is
moved into place with ``os.replace``: no process loads a half-written
library, and a process that finds the lock taken waits for that build
instead of concluding that there is no library.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libccst_io.so")
_LOCK = _SO + ".lock"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Build into a private name and move it into place; the caller holds
    the file lock."""
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-C", _HERE, f"OUT={os.path.basename(tmp)}"],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _open() -> Optional[ctypes.CDLL]:
    """The library, built first if needed, under the file lock: when the
    lock is ours no other process is writing the library."""
    try:
        fd = os.open(_LOCK, os.O_RDWR | os.O_CREAT, 0o644)
    except OSError:
        return None
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if not os.path.exists(_SO) and not _build():
            return None
        try:
            return ctypes.CDLL(_SO)
        except OSError:
            return None
    finally:
        os.close(fd)  # closing the descriptor releases the lock


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = _open()
        if lib is None:
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
