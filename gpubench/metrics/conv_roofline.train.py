"""conv_roofline.train (%): over the traced round, the least time its convs
could take (per computation, the larger of its operations at the float32 peak
and its bytes at the memory rate: each training step's forward, input and
weight gradients, each evaluation step's forward, at the batch's rows) over
the device time of cuDNN's conv kernels."""
from gpubench.flops import FP32_PEAK_FLOPS, bound_s, resnet
from gpubench.trace import family


def read(run):
    t = run.traced
    if t is None or run.device.type != "cuda":
        return None
    busy = t.time_of(lambda name: family(name) == "conv")
    if busy <= 0:
        return None
    size, batch, c = run.param("image_size"), run.param("batch"), run.counters
    bound = (c["traced_train_steps"] * sum(bound_s(o, b, FP32_PEAK_FLOPS)
                                           for o, b in resnet.conv_work(size, batch, True))
             + c["traced_eval_steps"] * sum(bound_s(o, b, FP32_PEAK_FLOPS)
                                            for o, b in resnet.conv_work(size, batch, False)))
    return 100.0 * bound / busy
