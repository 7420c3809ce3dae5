"""k3_roofline.wct (%): over the traced calls of the WCT cell, the least time
K3's convs could take at the cascade's shapes (``flops/wct.py::k3_bound_s``:
per launch the larger of its operations at the bfloat16 peak and its bytes at
the memory rate) over K3's device time."""
from gpubench.flops import wct
from gpubench.trace import kernel_id


def read(run):
    t = run.traced
    if t is None or run.device.type != "cuda":
        return None
    busy = t.time_of(lambda name: kernel_id(name) == "K3")
    if busy <= 0:
        return None
    return 100.0 * wct.k3_bound_s(wct.job_of(run.param)) * run.counters["traced_calls"] / busy
