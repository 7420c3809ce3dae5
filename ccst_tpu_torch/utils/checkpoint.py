"""Checkpoints of the federated runtime.

Counterpart of ``ccst_tpu/utils/checkpoint.py``. The port writes its payload
(``{"server", "round", "best"[, "clients"]}``, state dicts on the CPU) with
``torch.save`` to a temporary file and moves it into place with
``os.replace``, so a crash never leaves a torn ``latest``.

It also reads the msgpack checkpoints that ``ccst-tpu`` writes
(``flax.serialization.msgpack_serialize``), so that the port can test a
JAX-trained model. :func:`msgpack_restore` decodes the subset that flax
writes (maps, strings, numbers, nil, booleans, binary, arrays, and flax's
extension types 1, an ndarray, and 3, a numpy scalar, plus flax's chunked
arrays) in plain Python: the card's machine has no ``msgpack`` package. Orbax
directories are not read.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np
import torch

_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's zip container


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def is_msgpack_checkpoint(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) != _ZIP_MAGIC


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A ``torch.save`` payload of this package, or a ``ccst-tpu`` msgpack
    one (nested dicts of numpy arrays: the caller converts it)."""
    if is_msgpack_checkpoint(path):
        with open(path, "rb") as f:
            return msgpack_restore(f.read())
    return torch.load(path, map_location="cpu", weights_only=True)


def checkpoint_paths(save_path: str, run_name: str) -> Dict[str, str]:
    base = os.path.join(save_path, run_name)
    return {"latest": base + "_latest.ckpt", "best": base + "_best.ckpt"}


# ---------------------------------------------------------------------------
# msgpack, the subset flax writes
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = _Reader(data).value()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported")
    return np.frombuffer(bytes(buf), dtype=np.dtype(dtype)).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # tag: (length format, kind)
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
        }
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in fixext:
            return self.ext(fixext[b])
        if b not in sized:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        fmt, kind = sized[b]
        n = self.unpack(fmt)
        if kind == "bin":
            return self.take(n)
        if kind == "str":
            return self.take(n).decode()
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _unchunk(tree: Any) -> Any:
    """flax splits arrays above 1 GiB into ``__msgpack_chunked_array__`` maps."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore`` for what ``msgpack_serialize``
    writes, without the ``msgpack`` package."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(out)

