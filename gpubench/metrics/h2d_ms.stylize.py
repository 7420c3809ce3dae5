"""h2d_ms.stylize (ms a call): the port's ``stylize.h2d`` span (the content
batch's host-to-device copy in ``StylizeEngine._as_input``), a traced call."""
from gpubench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "stylize.h2d")
