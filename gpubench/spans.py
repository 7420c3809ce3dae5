"""The port's own spans, for the per-layer metrics that read them.

The port marks its work with ``ccst::<name>`` ranges on the profiler's clock
and keeps each span's seconds in memory while a profiler is active
(``ccst_tpu_torch/utils/profiling.py``: ``span``, ``record``). A reader takes a
span's seconds from that record (:func:`span_ms_per_call`), or the card's idle
time inside the ranges of some spans from the trace (:func:`port_ranges`
keeps the window's ranges, :func:`idle_within` measures the idle time in
them). A program without the record or the span reads as nothing.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

PREFIX = "ccst::"

Range = Tuple[str, float, float]  # (name, start s, end s)


def span_ms_per_call(run, name: str) -> Optional[float]:
    """Milliseconds a traced call in span ``name``, from the port's record of
    the traced window; ``None`` off the card or where the port has no such
    span."""
    calls = run.counters.get("traced_calls")
    if run.device.type != "cuda" or not calls:
        return None
    try:
        from ccst_tpu_torch.utils.profiling import record
    except ImportError:
        return None
    s = record()["spans"].get(name)
    if s is None:
        return None
    return 1e3 * s["seconds"] / calls


def port_ranges(events: Iterable, window) -> List[Range]:
    """The ``ccst::`` host ranges on the window's thread, clipped to the
    window, in seconds: ``events`` are a profile's events, ``window`` its
    window event."""
    from torch.autograd import DeviceType

    w0, w1 = window.time_range.start, window.time_range.end
    out = []
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if (e.device_type == DeviceType.CPU and e.thread == window.thread
                and e.name.startswith(PREFIX) and t1 > w0 and t0 < w1):
            out.append((e.name, max(t0, w0) * 1e-6, min(t1, w1) * 1e-6))
    return sorted(out, key=lambda r: r[1])


def _union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def idle_within(kernels: Sequence[Tuple[str, float, float]], ranges: Sequence[Range],
                names: Iterable[str]) -> float:
    """Seconds inside the union of the ranges named in ``names`` in which no
    kernel ran."""
    names = set(names)
    inside = _union((t0, t1) for name, t0, t1 in ranges if name in names)
    busy = _union((t0, t1) for _, t0, t1 in kernels)
    overlap, j = 0.0, 0
    for a0, a1 in inside:
        while j < len(busy) and busy[j][1] <= a0:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < a1:
            overlap += min(a1, busy[k][1]) - max(a0, busy[k][0])
            k += 1
    return sum(t1 - t0 for t0, t1 in inside) - overlap
