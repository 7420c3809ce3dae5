"""glue_ms.wct (ms a call): device time of the WCT cell's kernels that are
neither the port's K0-K5 nor the transform's (``flops/wct.py::KERNELS``):
PyTorch's casts, pools, upsamples, conv0, the transform's means and small
elementwise steps, the uint8 epilogue, a traced call."""
from gpubench.flops import wct
from gpubench.trace import kernel_id


def read(run):
    t = run.traced
    if t is None or run.device.type != "cuda":
        return None
    busy = t.time_of(lambda name: kernel_id(name) is None
                     and not any(f in name for f in wct.KERNELS))
    return 1e3 * busy / run.counters["traced_calls"]
