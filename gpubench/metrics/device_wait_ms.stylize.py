"""device_wait_ms.stylize (ms a call): the port's ``dispatch.wait`` span (the
host blocked in ``_DispatchAhead._flush`` on the kernels queued ahead of the
copy, the card computing), a traced call: the part of
``fetch_wait_ms.stylize`` that is not the copy."""
from gpubench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "dispatch.wait")
