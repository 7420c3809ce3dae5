"""Host-side image loading that keeps the device fed.

The package's own copy of ``ccst_tpu/data/loader.py`` (same names, same
bytes out). The reference relies on torch DataLoader worker processes doing
PIL decode+transform (data/ImageLoader.py:57-67). Here the host pipeline is a
thread-pool decoder with a bounded prefetch queue producing fixed-shape
float32/uint8 NHWC batches, so the device sees exactly one host->device
transfer per batch.

Static shapes: the final partial batch is padded to the fixed batch shape and
flagged via ``valid`` counts — consumers drop padded rows on the host after
device work.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ccst_tpu_torch.utils import profiling
from ccst_tpu_torch.utils.profiling import span

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def load_image(
    path: str, size: Optional[int] = None, dtype: str = "float32"
) -> np.ndarray:
    """Decode one image to HWC RGB — float32 in [0, 1] by default.

    ``size`` resizes to (size, size) with bilinear (matching the stylize-side
    transform Resize(S, S) + ToTensor, cjm_util/data_helper.py:46-49 — note:
    no ImageNet normalization on the stylize path).

    ``dtype="uint8"`` keeps the resized bytes: BIT-IDENTICAL content (the
    float path divides these exact bytes by 255) at 1/4 the memory and
    host->device traffic; the stylize engines normalize u8 on device.
    """
    if Image is None:
        raise RuntimeError("PIL is required for image loading")
    with Image.open(path) as im:
        im = im.convert("RGB")
        if size is not None and im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        if dtype == "uint8":
            return np.asarray(im, dtype=np.uint8)
        return np.asarray(im, dtype=np.float32) / 255.0


@dataclass
class Batch:
    images: np.ndarray          # (B, H, W, 3) float32 in [0,1], or uint8
    labels: np.ndarray          # (B,) int32
    paths: List[str]            # len == valid
    valid: int                  # rows < valid are real; rest padding


class ImageBatchLoader:
    """Iterable over fixed-shape batches with background decoding.

    Decoding runs in ``num_workers`` threads (PIL releases the GIL during
    JPEG decode) and up to ``prefetch`` assembled batches are buffered, so
    device compute overlaps host IO — the double-buffered input pipeline the
    BASELINE throughput target requires.
    """

    def __init__(
        self,
        paths: Sequence[str],
        labels: Optional[Sequence[int]] = None,
        *,
        batch_size: int,
        image_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        pad_final: bool = True,
        num_workers: int = 8,
        prefetch: int = 4,
        loop: bool = False,
        backend: str = "auto",   # "auto" | "native" | "pil"
        out_dtype: str = "float32",   # "float32" | "uint8" (u8 transport)
    ):
        if backend == "auto":
            from ccst_tpu_torch import native

            backend = "native" if native.available() else "pil"
        self.backend = backend
        self.paths = list(paths)
        self.labels = np.asarray(
            labels if labels is not None else np.zeros(len(self.paths)), np.int32
        )
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.loop = loop
        self.out_dtype = out_dtype
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.paths)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.paths))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def _assemble(self, pool: cf.Executor, idxs: np.ndarray) -> Batch:
        valid = len(idxs)
        if self.backend == "native":
            from ccst_tpu_torch import native

            images = native.decode_resize_batch(
                [self.paths[i] for i in idxs], self.image_size, self.num_workers
            )
            if self.out_dtype == "uint8":
                # exact: the native resize is PIL-parity (tests/test_native_io),
                # so every value is an integer/255 and the round-trip is
                # lossless. INVARIANT (advisor r4): this holds only while the
                # native resize emits exact integer/255 values — a future
                # native change producing fractional pixels would silently
                # perturb images here. tests/test_u8_transport covers it; set
                # CCST_CHECK_U8=1 to also assert it at runtime per batch.
                u8 = (images * 255.0 + 0.5).astype(np.uint8)
                if os.environ.get("CCST_CHECK_U8"):
                    if not np.array_equal(u8.astype(np.float32) / 255.0, images):
                        raise AssertionError(
                            "native resize produced non-integer/255 pixels; "
                            "the uint8 transport round-trip is no longer "
                            "lossless (see ccst_io.cpp resize parity)"
                        )
                images = u8
        else:
            futs = [
                pool.submit(
                    load_image, self.paths[i], self.image_size, self.out_dtype
                )
                for i in idxs
            ]
            images = np.stack([f.result() for f in futs], axis=0)
        labels = np.asarray(self.labels[idxs], np.int32)
        if valid < self.batch_size and self.pad_final:
            # pad by CYCLING the real rows (images AND labels), not zeros:
            # batch-statistic layers (BatchNorm train mode, the stat-free
            # DenseNet norm, MixStyle partners) see only real-image
            # statistics — zero-image padding dragged batch stats toward
            # the zero image and polluted every valid row's normalization,
            # a silent divergence from the reference's unpadded partial
            # batches. The loss/metrics mask still zeroes the padding rows.
            cyc = np.arange(self.batch_size - valid) % valid
            images = np.concatenate([images, images[cyc]])
            labels = np.concatenate([labels, labels[cyc]])
        return Batch(
            images=images,
            labels=labels,
            paths=[self.paths[i] for i in idxs],
            valid=valid,
        )

    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _SENTINEL = object()

        def producer() -> None:
            try:
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    while True:
                        order = self._order()
                        self._epoch += 1
                        n = len(order)
                        for start in range(0, n, self.batch_size):
                            if stop.is_set():
                                return
                            chunk = order[start : start + self.batch_size]
                            if len(chunk) < self.batch_size and self.drop_last:
                                continue
                            with span("loader.decode"):
                                batch = self._assemble(pool, chunk)
                            q.put(batch)
                        if not self.loop:
                            q.put(_SENTINEL)
                            return
            except BaseException as exc:  # surface decode errors to the consumer
                q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                traced = profiling.active()
                depth = q.qsize() if traced else 0
                item = q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                if traced:
                    profiling.count("loader.gets")
                    profiling.count("loader.queue_depth", depth)
                yield item
        finally:
            stop.set()
            # drain so the producer can observe `stop` and exit
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)


def save_image_u8(array: np.ndarray, path: str) -> None:
    """Save an HWC image like torchvision ``save_image``: clamp to [0,1],
    scale by 255, add 0.5, floor to uint8. Arrays already uint8 (e.g. from
    the engine's on-device quantization) pass through untouched.

    PNG outputs go through the native encoder when available (libpng at
    fast compression — ~10x quicker than PIL's default level on the
    write-back path, which otherwise dominates end-to-end stylize
    wall-clock)."""
    import os

    if array.dtype == np.uint8:
        arr = array
    else:
        arr = np.clip(array, 0.0, 1.0) * 255.0 + 0.5
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    lower = path.lower()
    if lower.endswith((".png", ".jpg", ".jpeg")):
        from ccst_tpu_torch import native

        if native.available():
            if lower.endswith(".png"):
                native.encode_png(path, np.ascontiguousarray(arr))
            else:
                native.encode_jpeg(path, np.ascontiguousarray(arr))
            return
    if Image is None:
        raise RuntimeError("PIL is required for image saving")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
