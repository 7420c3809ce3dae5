"""Hopper kernels (CUDA C++ in ``csrc/``), each beside its plain PyTorch version.

None of them has a backward: a wrapper given a tensor that requires grad while
grad mode is on raises (:func:`refuse_autograd`) rather than return a result
that is silently cut from the graph. Training runs its differentiable passes
through ``models/vgg.py``'s autograd route and only its grad-free passes here.
"""
from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if grad mode is on and any tensor among ``tensors`` requires
    grad. Checked on every device, so that a CPU run fails where the card
    would."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward, and an input requires grad; "
                           "run it under torch.no_grad() on detached tensors, or take the "
                           "autograd route")
