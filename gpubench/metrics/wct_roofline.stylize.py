"""wct_roofline.stylize (%): over the traced calls, the least time WCT's hand
kernel (``csrc/wct/wct_centre.cu``, device-memory bound) could take, its bytes
from shapes at the memory rate (``flops/wct.py::centre_split_bytes``), over its
device time; nothing where the trace holds no such kernel."""
from gpubench.flops import HBM_BYTES_S, wct


def read(run):
    t = run.traced
    if t is None or run.device.type != "cuda":
        return None
    busy = t.time_of(lambda name: wct.CENTRE_KERNEL in name)
    if busy <= 0:
        return None
    bound = wct.centre_split_bytes(wct.job_of(run.param)) / HBM_BYTES_S
    return 100.0 * bound * run.counters["traced_calls"] / busy
