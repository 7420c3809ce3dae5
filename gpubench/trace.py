"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics read.

The harness traces a window of its own, marked by a ``gpubench::window``
range on the host, and spans of its own around its calls into the port
(``gpubench::<name>`` ranges). From the trace it keeps the device kernels
inside the window (copies and memsets are not kernels), their busy time as
the union of their intervals, their time by name and by the port's kernel id,
and the idle gaps between them, each named by what the host was doing at the
gap's middle: the harness span and the innermost host operation open then.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "gpubench::window"
SPAN_PREFIX = "gpubench::"

# kernel-name fragment -> the port's kernel id (ccst_tpu_torch/benchmarks/
# stylize_profile.py); every other device kernel is PyTorch's glue or cuDNN's
KERNEL_IDS = (("qconv3x3_s8", "K0"), ("encoder_level1", "K1"), ("decoder_level1", "K2"),
              ("reflect_conv3x3", "K3"), ("adain_kernel", "K4"), ("channel_moments", "K5"))

# kernel-name fragments -> family, first match wins (ccst_tpu_torch/benchmarks/
# fed_profile.py)
FAMILIES = (
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("conv", ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop", "winograd", "xmma")),
    ("gemm", ("gemm", "gemv", "cublas", "sm90_", "splitk")),
    ("copy", ("copy", "memcpy", "memset", "fill")),
    ("elementwise / reduce", ("elementwise", "reduce", "vectorized", "unrolled", "softmax",
                              "max_pool", "avg_pool", "index", "cat", "sort", "scatter",
                              "gather", "where", "clamp")),
)


def kernel_id(name: str) -> Optional[str]:
    return next((k for frag, k in KERNEL_IDS if frag in name), None)


def family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, frags in FAMILIES if any(f in low for f in frags)), "other")


def _is_kernel(name: str) -> bool:
    """Not a copy, a memset, or the device-side mirror of a host range."""
    low = name.lower()
    return not (low.startswith(("memcpy", "memset")) or name.startswith(SPAN_PREFIX))


class Trace:
    """The traced window's kernels and idle gaps, times in seconds."""

    def __init__(self, kernels: List[Tuple[str, float, float]], window_s: float,
                 gaps: Dict[str, float]):
        self.kernels = kernels
        self.window_s = window_s
        self.gaps = gaps
        merged: List[List[float]] = []
        for _, t0, t1 in sorted(kernels, key=lambda k: k[1]):
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        self.busy_s = sum(t1 - t0 for t0, t1 in merged)

    def time_of(self, pick: Callable[[str], bool]) -> float:
        """Seconds of device time in the kernels whose name ``pick`` accepts."""
        return sum(t1 - t0 for name, t0, t1 in self.kernels if pick(name))

    def count_of(self, pick: Callable[[str], bool]) -> int:
        return sum(1 for name, _, _ in self.kernels if pick(name))

    def top_kernels(self, n: int = 10) -> List[List]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, t0, t1 in self.kernels:
            by_name[name[:120]] += t1 - t0
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]]


def reduce_profile(prof) -> Optional[Trace]:
    """The window's :class:`Trace`, or ``None`` if the trace holds no window
    or no device kernel in it."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    window = next((e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU),
                  None)
    if window is None:
        return None
    w0, w1 = window.time_range.start, window.time_range.end
    kernels = []
    host = []
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if _is_kernel(e.name) and t0 >= w0 and t1 <= w1 + 1e3:
                kernels.append((e.name, t0 * 1e-6, min(t1, w1) * 1e-6))
        elif e.thread == window.thread and e is not window and t1 > w0 and t0 < w1:
            host.append((t0, t1, e.name))
    if not kernels:
        return None
    trace = Trace(kernels, (w1 - w0) * 1e-6, {})
    trace.gaps = _label_gaps(trace, host, w0 * 1e-6, w1 * 1e-6)
    return trace


def _label_gaps(trace: Trace, host: List[Tuple[float, float, str]], w0: float, w1: float
                ) -> Dict[str, float]:
    """Idle seconds of the window by ``"<harness span> / <innermost host op>"``
    at each gap's middle."""
    edges = sorted((t0, t1) for _, t0, t1 in trace.kernels)
    gaps, end = [], w0
    for t0, t1 in edges:
        if t0 > end:
            gaps.append((end, t0))
        end = max(end, t1)
    if w1 > end:
        gaps.append((end, w1))
    spans = sorted((h for h in host if h[2].startswith(SPAN_PREFIX)), key=lambda h: h[0])
    ops = sorted((h for h in host if not h[2].startswith(SPAN_PREFIX)),
                 key=lambda h: (h[0], -h[1]))
    starts = [h[0] * 1e-6 for h in ops]
    labels: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        # the innermost open span or op is the open one that started last
        span = next((name[len(SPAN_PREFIX):] for t0, t1, name in reversed(spans)
                     if t0 * 1e-6 <= mid <= t1 * 1e-6), "no span")
        inner = "no host op"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(last - 2000, -1), -1):
            t0, t1, name = ops[j]
            if t1 * 1e-6 >= mid:
                inner = name
                break
        labels[f"{span} / {inner}"] += g1 - g0
    return dict(labels)
