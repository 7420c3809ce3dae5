"""Exact float32 on the card, and cuDNN's deterministic mode."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch


@contextmanager
def no_tf32(deterministic: bool = False) -> Iterator[None]:
    """float32 convs and matmuls in full float32 on the card (cuDNN convs
    default to TF32), restored afterwards. ``deterministic=True`` also asks
    cuDNN for deterministic algorithms and turns its autotuner off, so that a
    step gives the same bits every time."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved
