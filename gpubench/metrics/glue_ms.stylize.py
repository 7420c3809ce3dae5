"""glue_ms.stylize (ms a call): device time in kernels that are none of the
port's K0-K5 (PyTorch's casts, pools, upsamples, the uint8 quantization), a
traced call."""
from gpubench.trace import kernel_id


def read(run):
    t = run.traced
    if t is None or run.device.type != "cuda":
        return None
    return 1e3 * t.time_of(lambda name: kernel_id(name) is None) / run.counters["traced_calls"]
