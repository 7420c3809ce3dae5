"""stylize_mfu (%): the model FLOPs of the window's stylized images a second
over the peak of the engine's conv precision (bfloat16 989 TFLOP/s for
``ref``, int8 1,979 TOP/s for ``int8-fused``)."""
from gpubench.flops import PEAKS


def read(run):
    c = run.counters
    if run.device.type != "cuda" or not c.get("window_s"):
        return None
    flops_s = c["model_flops_per_call"] * c["calls"] / c["window_s"]
    return 100.0 * flops_s / PEAKS[run.param("precision")]
