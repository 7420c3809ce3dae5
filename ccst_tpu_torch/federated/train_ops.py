"""Per-client training and eval steps of the federated runtime.

Counterpart of ``ccst_tpu/federated/train_ops.py`` (the reference's local
update loops, federated/fed_run.py:31-211, and the DG-method dispatch in
them): plain cross-entropy, the Jigsaw two-head loss, RSC's gradient
percentile muting (utils/rsc_utils.py:32-75), the FedProx proximal term
against the server from local step 1 on (fed_run.py:163-169), and FedDG's
first-order meta step on a frequency-augmented view (fed_run.py:90-146).

A client state is the model's state dict (parameters and buffers); a step is
a plain function of (state, server state, batch, generator, step index) that
runs the model through ``torch.func.functional_call`` and returns a new state
dict: plain SGD built fresh each round like the reference, so there is no
optimizer state. ``batch`` holds NHWC "images" in [0, 1] on the device,
"labels" and "mask" (1 for a real row, 0 for padding); FedDG also needs
"amp_bank" (K, C, H, W). Every random draw (crop boxes, flips, Jigsaw orders,
FedDG picks and ratios, MixStyle's gate, lambda and permutation) comes from
the step's ``generator``, on the host.

Train-mode BatchNorm updates its running statistics in place, so a step works
on copies of the buffers: a batch whose mask is all 0 then leaves parameters
and statistics as they were (the padding rows do enter the batch statistics
of a real batch, as in JAX). The returned metrics are 0-d tensors on the
device; nothing here waits for the device.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ccst_tpu_torch.data.jigsaw import jigsaw_batch
from ccst_tpu_torch.ops.fft_aug import feddg_batch_augment
from ccst_tpu_torch.ops.image import eval_transform, train_transform

State = Dict[str, torch.Tensor]
RSC_PERCENT = (1 - 1 / 3) * 100  # mute the top third (rsc_utils.py)


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    correct: torch.Tensor    # class-head correct count
    count: torch.Tensor      # samples seen
    jig_correct: torch.Tensor
    active: torch.Tensor     # 1.0 if the step had any valid sample (0 = padded no-op)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=1)
    return -logp.gather(1, labels[:, None].long())[:, 0]


def _masked_mean(per_example: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(per_example * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _masked_percentile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """``percentile(x[mask > 0], q)`` ('linear') with a fixed shape: padding
    sorts to +inf and the rank is q/100 * (n_valid - 1), as in ``ccst_tpu``."""
    xs = torch.sort(torch.where(mask > 0, x, torch.full_like(x, float("inf")))).values
    n = torch.sum(mask)
    r = (q / 100.0) * torch.clamp(n - 1.0, min=0.0)
    lo = torch.clamp(torch.floor(r).long(), 0, x.shape[0] - 1)
    hi = torch.minimum(torch.clamp(lo + 1, min=0), torch.clamp(n.long() - 1, min=0))
    w = (r - lo).to(x.dtype)
    x_lo, x_hi = xs[lo], xs[hi]
    return x_lo + w * torch.where(w > 0, x_hi - x_lo, torch.zeros_like(x_lo))


def model_keys(model: nn.Module) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(parameter names, buffer names) of a model, in state-dict order."""
    return (tuple(k for k, _ in model.named_parameters()),
            tuple(k for k, _ in model.named_buffers()))


def forward(model: nn.Module, state: State, images_nhwc: torch.Tensor, train: bool, **kw):
    """The model on ``state`` (only the model's own keys of it: an ``--in-test``
    model has no running statistics) for NHWC images."""
    params, buffers = model_keys(model)
    model.train(train)
    x = images_nhwc.permute(0, 3, 1, 2)  # NCHW view in channels-last memory
    return functional_call(model, {k: state[k] for k in params + buffers}, (x,), kw)


def _head(state: State, features: torch.Tensor) -> torch.Tensor:
    name = "class_classifier" if "class_classifier.weight" in state else "classifier"
    return F.linear(features, state[f"{name}.weight"], state[f"{name}.bias"])


def _rsc_logits(model, state: State, images, labels, n_classes: int, mask_valid):
    """RSC's muted logits (utils/rsc_utils.py:32-75) from ONE backbone forward
    (BN statistics update once): mute the features of the top third of the
    head's gradient per sample, unmute the samples in the bottom two thirds of
    the prediction change. ``mask_valid`` keeps padding out of the batch
    percentile."""
    feats = forward(model, state, images, True, return_features=True)
    onehot = F.one_hot(labels.long(), n_classes).to(feats.dtype)
    f = feats.detach().requires_grad_(True)
    head_w = {k: v.detach() for k, v in state.items() if "classifier" in k}
    g = torch.autograd.grad(torch.sum(_head(head_w, f) * onehot), f)[0]
    pct_f = torch.quantile(g, RSC_PERCENT / 100.0, dim=1, keepdim=True)
    mask_f = (g < pct_f).to(feats.dtype)
    with torch.no_grad():
        s = F.softmax(_head(state, feats), dim=1)
        s_muted = F.softmax(_head(state, feats * mask_f), dim=1)
        changes = torch.sum(s * onehot, dim=1) - torch.sum(s_muted * onehot, dim=1)
        pct_b = _masked_percentile(changes.float(), mask_valid, RSC_PERCENT).to(changes.dtype)
    mask_b = (changes < pct_b).to(feats.dtype)[:, None]
    return _head(state, feats * torch.maximum(mask_f, mask_b))


def _prox_term(params: State, server: State) -> torch.Tensor:
    return sum(torch.sum(torch.square(p.float() - server[k].float())) for k, p in params.items())


def make_train_step(
    model: nn.Module,
    *,
    n_classes: int,
    image_size: int,
    lr: float,
    dg_method: str = "no_DG",
    mode: str = "fedavg",
    mu: float = 1e-3,
    jig_weight: float = 0.7,
    jigsaw_n_classes: int = 30,
    bias_whole_image: float = 0.9,
    meta_step_size: float = 1e-3,
    clip_value: float = 1.0,
    min_scale: float = 0.8,
    max_scale: float = 1.0,
) -> Callable:
    """One client-local SGD step:
    ``step(state, server_state, batch, generator, step_idx) -> (state, StepMetrics)``."""
    dg = dg_method.lower()
    is_prox = mode.lower() == "fedprox"
    param_keys, buffer_keys = model_keys(model)

    def prepare(images, generator):
        return train_transform(generator, images, image_size, min_scale, max_scale)

    def losses(params: State, buffers: State, old_buffers: State, batch, generator, mask,
               labels):
        """(loss, logits for the metrics, jig correct count); ``buffers`` (copies
        of ``old_buffers``) take the forward's new running statistics."""
        state = {**params, **buffers}
        jig_corr = torch.zeros((), device=mask.device)
        if dg == "jigsaw":
            # the reference's model reads the permuted grid image for BOTH heads
            # (fed_run.py:58); the grid goes through the train transform
            jig_images, jig_labels = jigsaw_batch(generator, batch["images"], jigsaw_n_classes,
                                                  bias_whole_image)
            logits, jig_logits = forward(model, state, prepare(jig_images, generator), True)
            loss = (_masked_mean(cross_entropy(logits, labels), mask)
                    + jig_weight * _masked_mean(cross_entropy(jig_logits, jig_labels), mask))
            jig_corr = torch.sum((jig_logits.argmax(1) == jig_labels).float() * mask)
        elif dg == "rsc":
            images = prepare(batch["images"], generator)
            logits = _rsc_logits(model, state, images, labels, n_classes, mask)
            loss = _masked_mean(cross_entropy(logits, labels), mask)
        elif dg == "feddg":
            images = eval_transform(batch["images"], image_size)
            freq = eval_transform(
                feddg_batch_augment(generator, batch["images"], batch["amp_bank"], L=0.0),
                image_size)
            logits = forward(model, state, images, True)
            l_inner = _masked_mean(cross_entropy(logits, labels), mask)
            grads = torch.autograd.grad(l_inner, list(params.values()), retain_graph=True,
                                        allow_unused=True)
            # FOMAML (fed_run.py:110): the inner gradients are constants
            fast = {k: (p if g is None else
                        p - meta_step_size * torch.clamp(g.detach(), -clip_value, clip_value))
                    for (k, p), g in zip(params.items(), grads)}
            # the outer pass's statistics are discarded: it runs on copies
            outer_buffers = {k: v.clone() for k, v in old_buffers.items()}
            lg_out = forward(model, {**fast, **outer_buffers}, freq, True)
            loss = l_inner + _masked_mean(cross_entropy(lg_out, labels), mask)
        else:  # no_DG / mixstyle (MixStyle draws inside the model)
            kw = {"generator": generator} if dg == "mixstyle" else {}
            logits = forward(model, state, prepare(batch["images"], generator), True, **kw)
            loss = _masked_mean(cross_entropy(logits, labels), mask)
        return loss, logits, jig_corr

    def step(state: State, server_state: State, batch, generator: torch.Generator,
             step_idx: int) -> Tuple[State, StepMetrics]:
        mask = batch["mask"].float()
        labels = batch["labels"]
        params = {k: state[k].detach().requires_grad_(True) for k in param_keys}
        buffers_before = {k: state[k] for k in buffer_keys}
        buffers = {k: v.clone() for k, v in buffers_before.items()}
        with torch.enable_grad():
            loss, logits, jig_corr = losses(params, buffers, buffers_before, batch, generator,
                                            mask, labels)
            if is_prox and step_idx > 0:
                loss = loss + (mu / 2.0) * _prox_term(params, server_state)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        any_valid = torch.sum(mask) > 0
        with torch.no_grad():
            new_state = {k: (p.detach() if g is None else
                             torch.where(any_valid, p - lr * g.to(p.dtype), p))
                         for (k, p), g in zip(params.items(), grads)}
            for k in buffer_keys:
                new_state[k] = torch.where(any_valid, buffers[k], buffers_before[k])
            active = any_valid.float()
            metrics = StepMetrics(
                loss=loss.detach() * active,
                correct=torch.sum((logits.argmax(1) == labels).float() * mask),
                count=torch.sum(mask),
                jig_correct=jig_corr.detach(),
                active=active,
            )
        return {k: new_state[k] for k in state}, metrics

    return step


def make_eval_step(model: nn.Module, *, image_size: int):
    """``step(state, batch) -> (loss sum, correct, count)``, 0-d tensors on the
    device: resize + normalize, logits (the class head of a Jigsaw model) in
    eval mode (``test()``, fed_run.py:214-259)."""

    def step(state: State, batch) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        images = eval_transform(batch["images"], image_size)
        with torch.no_grad():
            logits = forward(model, state, images, False)
            if isinstance(logits, tuple):
                logits = logits[0]
            mask = batch["mask"].float()
            ce = cross_entropy(logits, batch["labels"])
            correct = torch.sum((logits.argmax(1) == batch["labels"]).float() * mask)
        return torch.sum(ce * mask), correct, torch.sum(mask)

    return step
