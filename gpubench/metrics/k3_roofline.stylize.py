"""k3_roofline.stylize (%): over the traced calls, the least time K3's convs
could take (per launch, the larger of its operations at the bfloat16 peak and
its bytes at the memory rate, counted from shapes) over K3's device time."""
from gpubench.flops import vgg
from gpubench.trace import kernel_id


def read(run):
    t = run.traced
    if t is None or run.device.type != "cuda":
        return None
    busy = t.time_of(lambda name: kernel_id(name) == "K3")
    if busy <= 0:
        return None
    bound = vgg.kernel_bound_s(run.param("engine"), vgg.job_of(run.param), {"K3"})
    return 100.0 * bound * run.counters["traced_calls"] / busy
