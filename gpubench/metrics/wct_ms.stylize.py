"""wct_ms.stylize (ms a call): device time of the WCT transform's kernels (the
Gram, the inverse square roots and the apply of ``ops/wct.py``), named by the
fragments ``flops/wct.py::KERNELS``, a traced call; nothing where the port
solved no WCT matrix in the traced window (``wct.solves``)."""
from gpubench.flops import wct


def read(run):
    t = run.traced
    if t is None or run.device.type != "cuda" or not run.counters.get("wct.solves"):
        return None
    busy = t.time_of(lambda name: any(f in name for f in wct.KERNELS))
    if busy <= 0:
        return None
    return 1e3 * busy / run.counters["traced_calls"]
