"""The port's ``ccst::`` spans in a trace, and the readers of
``gpubench/spans.py`` on synthetic events and records: ``reduce_profile``
computes what it computed without them, ``idle_within`` matches a hand count,
the readers give their values on the card and nothing off it or where the
program has no such span. On the card: the spans leave no device event."""
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from gpubench import harness
from gpubench.spans import idle_within, port_ranges
from gpubench.trace import WINDOW, Trace, reduce_profile

CUDA = torch.device("cuda", 0)  # a device object only: nothing runs on it here
MAIN, OTHER = 1, 2


def ev(name, t0, t1, device=DeviceType.CPU, thread=MAIN):
    """A profiler event, times in microseconds."""
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           time_range=SimpleNamespace(start=t0, end=t1))


def kernel(name, t0, t1):
    return ev(name, t0, t1, DeviceType.CUDA, thread=0)


# a window of two calls: kernels, a pageable h2d and d2h (the card idle), host ops
BASE = [
    ev(WINDOW, 0, 10_000),
    ev("gpubench::call", 0, 5_000), ev("gpubench::call", 5_000, 10_000),
    ev("cudaMemcpyAsync", 100, 1_000),            # h2d of call 1: idle 0-1000
    kernel("reflect_conv3x3_wgmma_kernel", 1_000, 3_000),
    kernel("elementwise_kernel", 3_000, 3_500),
    ev("cudaMemcpyAsync", 3_600, 4_800),          # d2h: idle 3500-5200
    ev("cudaMemcpyAsync", 5_300, 6_000),          # h2d of call 2: idle 5200-6000
    kernel("reflect_conv3x3_wgmma_kernel", 6_000, 8_000),
    ev("aten::add", 8_100, 8_200),                # a gap with the host in Python: 8000-10000
    kernel("Memcpy DtoH (Device -> Pageable)", 3_600, 4_800),
    ev("cudaMemcpyAsync", 500, 600, thread=OTHER),
]
SPANS = [
    ev("ccst::stylize.h2d", 50, 1_000), ev("ccst::stylize.encode", 1_000, 2_000),
    ev("ccst::dispatch.wait", 3_100, 3_500), ev("ccst::dispatch.d2h", 3_550, 4_900),
    ev("ccst::stylize.h2d", 5_200, 6_050), ev("ccst::dispatch.emit", 8_050, 9_500),
    ev("ccst::stylize.h2d", 500, 600, thread=OTHER),
    ev("ccst::stylize.h2d", 10_500, 11_000),      # after the window
]


def test_reduce_profile_computes_the_same_with_the_ports_ranges():
    plain = reduce_profile(SimpleNamespace(events=lambda: list(BASE)))
    spanned = reduce_profile(SimpleNamespace(events=lambda: BASE + SPANS))
    assert spanned.kernels == plain.kernels and len(plain.kernels) == 3
    assert spanned.busy_s == pytest.approx(plain.busy_s) and plain.busy_s == pytest.approx(0.0045)
    assert spanned.window_s == plain.window_s == pytest.approx(0.01)
    assert spanned.top_kernels() == plain.top_kernels()
    # the copies' gaps keep their labels; where the host ran no op, the
    # port's range open there names the gap
    moved = {"call / no host op": "call / ccst::dispatch.emit"}
    assert {moved.get(k, k): v for k, v in plain.gaps.items()} == spanned.gaps
    assert plain.gaps["call / cudaMemcpyAsync"] == pytest.approx(0.0035)
    assert [k for k, _ in spanned.top_gaps()] == [
        "call / cudaMemcpyAsync", "call / ccst::dispatch.emit"]


def test_port_ranges_keep_the_windows_thread_and_clip_to_it():
    window = BASE[0]
    ranges = port_ranges(BASE + SPANS + [ev("ccst::early", -50, 20)], window)
    assert ranges[0] == ("ccst::early", 0.0, pytest.approx(20e-6))
    assert [r[0] for r in ranges[1:]] == ["ccst::stylize.h2d", "ccst::stylize.encode",
                                          "ccst::dispatch.wait", "ccst::dispatch.d2h",
                                          "ccst::stylize.h2d", "ccst::dispatch.emit"]
    assert all(0 <= t0 < t1 <= 0.01 for _, t0, t1 in ranges)


def test_idle_within_matches_a_hand_count():
    window = BASE[0]
    trace = reduce_profile(SimpleNamespace(events=lambda: BASE + SPANS))
    ranges = port_ranges(BASE + SPANS, window)
    copies = ("ccst::stylize.h2d", "ccst::dispatch.d2h")
    # h2d 50-1000 all idle (950); d2h 3550-4900 all idle (1350); h2d 5200-6050
    # idle until the kernel at 6000 (800)
    assert idle_within(trace.kernels, ranges, copies) == pytest.approx((950 + 1350 + 800) * 1e-6)
    # encode 1000-2000 is all kernel; wait 3100-3500 too
    assert idle_within(trace.kernels, ranges, ["ccst::stylize.encode",
                                               "ccst::dispatch.wait"]) == pytest.approx(0.0)
    # emit 8050-9500: idle throughout
    assert idle_within(trace.kernels, ranges, ["ccst::dispatch.emit"]) == pytest.approx(1450e-6)
    # overlapping ranges count once
    doubled = ranges + [("ccst::stylize.h2d", 100e-6, 900e-6)]
    assert idle_within(trace.kernels, doubled, copies) == pytest.approx(3100e-6)
    assert idle_within(trace.kernels, ranges, ["ccst::absent"]) == 0.0


def _run(device, traced=None, calls=4):
    return SimpleNamespace(device=device, traced=traced, counters={"traced_calls": calls})


def test_the_span_readers_read_the_ports_record():
    from ccst_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for name, s in (("stylize.h2d", 0.004), ("dispatch.wait", 0.012),
                            ("dispatch.d2h", 0.008)):
                with profiling.span(name):
                    time.sleep(s)
        rec = profiling.record()["spans"]
        for metric, span in (("h2d_ms.stylize", "stylize.h2d"),
                             ("device_wait_ms.stylize", "dispatch.wait"),
                             ("d2h_ms.stylize", "dispatch.d2h")):
            read = harness.reader(metric)
            assert read(_run(CUDA)) == pytest.approx(1e3 * rec[span]["seconds"] / 4)
            assert read(_run(torch.device("cpu"))) is None
            assert read(_run(CUDA, calls=0)) is None
        profiling.reset()  # a program that did not record the span
        assert harness.reader("h2d_ms.stylize")(_run(CUDA)) is None
    finally:
        profiling.reset()


def test_copy_idle_reads_the_windows_ranges_and_nothing_without_them():
    read = harness.reader("copy_idle.stylize")
    trace = reduce_profile(SimpleNamespace(events=lambda: BASE + SPANS))
    assert read(_run(CUDA, trace)) is None  # the trace keeps no port ranges
    trace.spans = port_ranges(BASE + SPANS, BASE[0])
    assert read(_run(CUDA, trace)) == pytest.approx(100.0 * 3100e-6 / 0.01)
    assert read(_run(torch.device("cpu"), trace)) is None
    assert read(_run(CUDA, None)) is None
    assert isinstance(trace, Trace)


@pytest.mark.card
def test_the_ports_spans_leave_no_device_event(cuda_device):
    """The port's ranges are host ranges only: none is mirrored on the device,
    where ``reduce_profile`` would count it as a kernel."""
    from torch.profiler import ProfilerActivity, profile

    from ccst_tpu_torch.utils import profiling

    x = torch.randn(1 << 20, device=cuda_device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(3):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        y = (x * 2).sum()
                    y.cpu()
    events = list(prof.events())
    assert [e.name for e in events if e.device_type == DeviceType.CPU].count("ccst::inner") == 3
    assert not [e.name for e in events
                if e.device_type == DeviceType.CUDA and e.name.startswith("ccst::")]
    trace = reduce_profile(prof)
    assert trace is not None and not [k for k in trace.kernels if k[0].startswith("ccst::")]
