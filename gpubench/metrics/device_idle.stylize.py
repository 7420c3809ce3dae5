"""device_idle.stylize (%): 1 minus the union of the kernels' intervals over
the traced window."""


def read(run):
    t = run.traced
    if t is None or run.device.type != "cuda":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
