"""Profiling: one ``torch.profiler`` trace, and the port's spans and counters
inside it.

:func:`maybe_trace` is the operator's switch: a ``torch.profiler`` trace of
the CPU and, where there is one, the CUDA device into ``trace_dir`` (a Chrome
trace, viewable in Perfetto, as ``trace.json``), with the port's span and
counter record beside it (``spans.json``); nothing when ``trace_dir`` is
empty.

:func:`span` and :func:`count` mark the port's own work. While a profiler is
active in the process (any ``torch.profiler.profile``, the benchmark's too),
a span opens a ``ccst::<name>`` range in the trace, on the profiler's clock
beside the kernels and copies, and adds its duration and self time (the
duration less that of the spans nested in it on the same thread) to an
in-memory record; a counter adds to the same record. Spans on other threads,
such as the loader's, are recorded too; the profiler traces their ranges only
if it profiles every thread. While no profiler is active, :func:`span`
returns one shared no-op context and :func:`count` returns at once: no range,
no allocation, no clock read.

The ranges are function-scope record functions, not user annotations: a user
annotation is mirrored on the device as an event of the same name spanning
the work launched inside it, which a reader of the trace would count as a
kernel.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch
import torch.autograd.profiler as _torch_profiler
from torch._C._profiler import _RecordFunctionFast as _range

PREFIX = "ccst::"

_NO_SPAN = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_spans: Dict[str, Dict[str, float]] = {}
_counters: Dict[str, float] = {}


def active() -> bool:
    """Whether a ``torch.profiler`` profile runs in this process: torch's own
    process-wide flag (its C flag is per thread, and the loader decodes on
    threads of its own)."""
    return _torch_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "range", "t0", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.child = 0.0
        self.range = _range(PREFIX + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        with _lock:
            rec = _spans.get(self.name)
            if rec is None:
                rec = _spans[self.name] = {"count": 0, "seconds": 0.0, "self_seconds": 0.0}
            rec["count"] += 1
            rec["seconds"] += dt
            rec["self_seconds"] += dt - self.child


def span(name: str):
    """A ``ccst::<name>`` range and a record entry while a profiler is
    active; the shared no-op context otherwise."""
    if not active():
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler is active."""
    if not active():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def record() -> Dict[str, Dict]:
    """A copy of the record: ``{"spans": {name: {"count", "seconds",
    "self_seconds"}}, "counters": {name: total}}``."""
    with _lock:
        return {"spans": {k: dict(v) for k, v in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Trace the block into ``trace_dir/trace.json``, and write the spans
    and counters it recorded to ``trace_dir/spans.json``, when set; no-op
    otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump(record(), f, indent=2, sort_keys=True)
