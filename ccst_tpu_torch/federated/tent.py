"""Tent: test-time entropy minimization (Wang et al., ICLR 2021).

Counterpart of ``ccst_tpu/federated/tent.py`` (the reference ships tent call
sites, federated/fed_run.py:261-347, 597-623, but not the library): at test
time only the BatchNorm affine parameters (weight / bias under a ``bn``
module) adapt, by plain SGD (lr 1e-3) on the mean prediction entropy, with BN
in batch-statistics mode whose running statistics are not kept.

  - ``tent_test``: epochs over the test set, adapting on each batch, then a
    frozen re-evaluation a epoch (fed_run.py:261-313);
  - ``tent_test_on_the_fly``: K adaptation steps a batch, predict, move on
    (fed_run.py:315-347).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ccst_tpu_torch.federated.aggregate import is_bn_key
from ccst_tpu_torch.federated.train_ops import forward, make_eval_step, model_keys
from ccst_tpu_torch.ops.image import eval_transform

State = Dict[str, torch.Tensor]


def entropy_loss(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    p = F.softmax(logits.float(), dim=1)
    logp = F.log_softmax(logits.float(), dim=1)
    ent = -torch.sum(p * logp, dim=1)
    return torch.sum(ent * mask) / torch.clamp(torch.sum(mask), min=1.0)


def make_tent_step(model: nn.Module, image_size: int, lr: float = 1e-3):
    """``step(state, batch) -> (state, correct, count)``: one train-mode
    forward, the entropy gradient applied to the BN affine parameters only."""
    param_keys, buffer_keys = model_keys(model)
    adapted = [k for k in param_keys if is_bn_key(k)]

    def step(state: State, batch) -> Tuple[State, torch.Tensor, torch.Tensor]:
        mask = batch["mask"].float()
        images = eval_transform(batch["images"], image_size)
        params = {k: state[k].detach().requires_grad_(k in adapted) for k in param_keys}
        scratch = {k: state[k].clone() for k in buffer_keys}  # statistics not kept
        with torch.enable_grad():
            logits = forward(model, {**params, **scratch}, images, True)
            if isinstance(logits, tuple):
                logits = logits[0]
            grads = torch.autograd.grad(entropy_loss(logits, mask), [params[k] for k in adapted])
        new_state = dict(state)
        with torch.no_grad():
            for k, g in zip(adapted, grads):
                new_state[k] = state[k] - lr * g
            correct = torch.sum((logits.argmax(1) == batch["labels"]).float() * mask)
        return new_state, correct, torch.sum(mask)

    return step


def tent_test(model: nn.Module, state: State, loader, image_size: int, batch_dict,
              lr: float = 1e-3, epochs: int = 10, logger=None) -> Tuple[State, float]:
    """Adapt over the test stream for ``epochs``; returns (adapted state, the
    last frozen accuracy). ``batch_dict`` turns a loader batch into the step's
    dict on the device (``runtime.FederatedRunner.batch_dict``)."""
    step = make_tent_step(model, image_size, lr)
    eval_step = make_eval_step(model, image_size=image_size)
    acc = 0.0
    for epoch in range(epochs):
        run_c = run_n = 0.0
        for batch in loader:
            state, c, n = step(state, batch_dict(batch))
            run_c += float(c)
            run_n += float(n)
        frozen_c = frozen_n = 0.0
        for batch in loader:
            _, c, n = eval_step(state, batch_dict(batch))
            frozen_c += float(c)
            frozen_n += float(n)
        acc = frozen_c / max(frozen_n, 1.0)
        if logger is not None:
            logger.log("tent_epoch", epoch=epoch, running_acc=run_c / max(run_n, 1.0),
                       frozen_acc=acc)
    return state, acc


def tent_test_on_the_fly(model: nn.Module, state: State, loader, image_size: int, batch_dict,
                         lr: float = 1e-3, steps_per_batch: int = 10, logger=None) -> float:
    """Adapt K steps on each batch, then score it (fed_run.py:315-347)."""
    step = make_tent_step(model, image_size, lr)
    correct = count = 0.0
    for batch in loader:
        bd = batch_dict(batch)
        c = n = torch.zeros(())
        for _ in range(steps_per_batch):
            state, c, n = step(state, bd)
        correct += float(c)
        count += float(n)
    acc = correct / max(count, 1.0)
    if logger is not None:
        logger.log("tent_on_the_fly", acc=acc)
    return acc
