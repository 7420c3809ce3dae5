"""d2h_ms.stylize (ms a call): the port's ``dispatch.d2h`` span (the copy of
the outputs to the host in ``_DispatchAhead._flush``, after the card has
finished the kernels queued ahead of it), a traced call."""
from gpubench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "dispatch.d2h")
