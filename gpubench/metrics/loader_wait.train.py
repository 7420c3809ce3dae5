"""loader_wait.train (%): the rounds' own ``loader_wait_seconds`` (the host
blocked on the port's loader, ``federated/runtime.py``) over the window."""


def read(run):
    c = run.counters
    if run.device.type != "cuda" or not c.get("window_s"):
        return None
    return 100.0 * c["loader_wait_s"] / c["window_s"]
