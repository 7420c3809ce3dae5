"""fetch_wait_ms.stylize (ms a call): the port's own counter of the time its
dispatch-ahead loop (``pipeline/stylize.py::_DispatchAhead``) sat in the
device-to-host copies, over the window's calls."""


def read(run):
    c = run.counters
    if run.device.type != "cuda" or not c.get("calls"):
        return None
    return 1e3 * c["fetch_seconds"] / c["calls"]
