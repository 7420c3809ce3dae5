"""copy_idle.stylize (%): the share of the traced window in which no kernel
ran while the port's ``ccst::stylize.h2d`` or ``ccst::dispatch.d2h`` range
was open: the card idle on the host's copies. Reads the window's ``ccst::``
ranges (``trace.spans``, from ``gpubench.spans.port_ranges``); nothing where
the trace holds none."""
from gpubench.spans import idle_within

COPIES = ("ccst::stylize.h2d", "ccst::dispatch.d2h")


def read(run):
    t = run.traced
    if t is None or run.device.type != "cuda" or not getattr(t, "spans", None):
        return None
    return 100.0 * idle_within(t.kernels, t.spans, COPIES) / t.window_s
