"""Exact float32 on the card."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch


@contextmanager
def no_tf32() -> Iterator[None]:
    """float32 convs and matmuls in full float32 on the card (cuDNN convs
    default to TF32), restored afterwards."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
