"""Plain PyTorch references of the benchmark's configurations.

They import nothing of ``ccst_tpu_torch`` (``tests/test_gpubench_imports.py``
holds that) and take nothing the port made: the harness hands them the
weights and inputs it made itself, and they work out again every table the
port derived from those (style banks, calibration scales, crops). They run in
float32 with TF32 off, or in float64, in blocks of rows, once the measured
window has closed.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch


@contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    """cuDNN convs and matmuls in full float32 (``tf32=False``) or in TF32,
    restored afterwards."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
