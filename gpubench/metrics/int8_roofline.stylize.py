"""int8_roofline.stylize (%): as ``k3_roofline.stylize``, over the int8
kernels K0, K1 and K2 at the int8 peak."""
from gpubench.flops import vgg
from gpubench.trace import kernel_id

KERNELS = {"K0", "K1", "K2"}


def read(run):
    t = run.traced
    if t is None or run.device.type != "cuda":
        return None
    busy = t.time_of(lambda name: kernel_id(name) in KERNELS)
    if busy <= 0:
        return None
    bound = vgg.kernel_bound_s(run.param("engine"), vgg.job_of(run.param), KERNELS)
    return 100.0 * bound * run.counters["traced_calls"] / busy
