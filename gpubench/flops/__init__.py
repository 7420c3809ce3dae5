"""Operation and byte counts from shapes, and the peaks they are held to.

The peaks are those of one NVIDIA H100 SXM at its 700 W power limit (NVIDIA's
data sheet, dense rates without sparsity), as ``ccst_tpu_torch/benchmarks``
states them. A roofline share is the least time the chip could take, the
larger of operations over the peak rate and bytes over the memory rate, over
the time the kernel took.
"""
from __future__ import annotations

BF16_PEAK_FLOPS = 989e12
INT8_PEAK_OPS = 1979e12
FP32_PEAK_FLOPS = 67e12   # float32 outside the tensor cores (TF32 off)
HBM_BYTES_S = 3.35e12

PEAKS = {"bfloat16": BF16_PEAK_FLOPS, "int8": INT8_PEAK_OPS, "float32": FP32_PEAK_FLOPS}


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """The least time for ``ops`` operations and ``nbytes`` bytes of device
    memory traffic at ``peak`` operations a second."""
    return max(ops / peak, nbytes / HBM_BYTES_S)
