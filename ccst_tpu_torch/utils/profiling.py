"""Profiling helpers of the training stage.

Counterpart of ``ccst_tpu/utils/profiling.py::maybe_trace``: a
``torch.profiler`` trace of the CPU and, where there is one, the CUDA device
into ``trace_dir`` (a Chrome trace, viewable in Perfetto), or nothing.
"""
from __future__ import annotations

import contextlib
import os
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
