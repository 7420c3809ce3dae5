"""train_mfu (%): the model FLOPs of the window's rounds (each training image
forward, input and weight gradients; each evaluated image forward) a second,
over the float32 peak of 67 TFLOP/s (TF32 off)."""
from gpubench.flops import FP32_PEAK_FLOPS, resnet


def read(run):
    c = run.counters
    if run.device.type != "cuda" or not c.get("window_s"):
        return None
    size, classes = run.param("image_size"), run.param("classes")
    flops = (resnet.train_flops(size, classes) * c["train_images"]
             + resnet.forward_flops(size, classes) * c["eval_images"])
    return 100.0 * flops / c["window_s"] / FP32_PEAK_FLOPS
