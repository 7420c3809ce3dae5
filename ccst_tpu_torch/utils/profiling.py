"""Profiling helpers.

Counterpart of ``ccst_tpu/utils/profiling.py``: :func:`maybe_trace`, a
``torch.profiler`` trace of the CPU and, where there is one, the CUDA device
into ``trace_dir`` (a Chrome trace, viewable in Perfetto), or nothing; and
:class:`StageTimer`, the same wall-clock stage record as ``ccst_tpu``'s.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Trace the block into ``trace_dir/trace.json`` when set; no-op otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


class StageTimer:
    """Wall-clock stage timer producing the reference-style timing record
    (images, seconds, img/s) as a dict — the machine-readable form of
    e.g. ``pacs_art_painting_overall_stylize_time.txt``."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.images = 0

    def add(self, n: int) -> None:
        self.images += n

    def report(self, **extra) -> dict:
        dt = time.perf_counter() - self.t0
        return {
            "images": self.images,
            "seconds": dt,
            "images_per_sec": self.images / max(dt, 1e-9),
            **extra,
        }
