"""Per-client training and eval steps of the federated runtime.

Counterpart of ``ccst_tpu/federated/train_ops.py`` (the reference's local
update loops, federated/fed_run.py:31-211, and the DG-method dispatch in
them): plain cross-entropy, the Jigsaw two-head loss, RSC's gradient
percentile muting (utils/rsc_utils.py:32-75), the FedProx proximal term
against the server from local step 1 on (fed_run.py:163-169), and FedDG's
first-order meta step on a frequency-augmented view (fed_run.py:90-146).

A client state is the model's state dict (parameters and buffers); plain SGD
built fresh each round like the reference, so there is no optimizer state.
``make_train_step`` returns a :class:`TrainStep` in two halves:

- ``draw(generator, batch) -> draws``: every random draw of the step, on the
  host from the generator, in this order: Jigsaw's orders or FedDG's picks and
  ratios, the train transform's crop boxes then flips (not FedDG's), then
  MixStyle's gate, lambda and permutation for each of its stages;
- ``apply(state, server_state, batch, draws, step_idx) -> (state,
  StepMetrics)``: a pure function of its inputs, which runs the model through
  ``torch.func.functional_call`` and takes the gradient with
  ``torch.func.grad_and_value``, so ``torch.func.vmap`` can step a stack of
  clients at once (``parallel/fed_mesh.py``; the JAX step takes a key a
  client for the same reason).

Calling the step, ``step(state, server_state, batch, generator, step_idx)``,
is ``apply`` of ``draw``. ``batch`` holds NHWC "images" in [0, 1] on the
device, "labels" and "mask" (1 for a real row, 0 for padding); FedDG also
needs "amp_bank" (K, C, H, W).

Train-mode BatchNorm updates its running statistics in place, so a step works
on copies of the buffers, handed to the gradient transform as an input of its
own (functorch refuses a mutation of a captured tensor): a batch whose mask is
all 0 then leaves parameters and statistics as they were (the padding rows do
enter the batch statistics of a real batch, as in JAX). The returned metrics
are 0-d tensors on the device; nothing here waits for the device.

``data_reduce`` (``parallel/fed_mesh.py::DataGroup``) makes the step one
rank's share of a batch split over a data group of ranks: the masked means
divide by the group's row count, and the gradients, the BatchNorm batch
statistics (the model's BatchNorm swapped for ``GroupBatchNorm``) and the
metrics are summed over the group inside the step. What mixes rows sees the
client's whole batch, as ``ccst_tpu``'s step under a (client, data) mesh
does: ``data_gather`` gathers RSC's per-row prediction changes for its batch
percentile, and the model's MixStyle (``fed_mesh.with_data_group``) the rows'
statistics for its permutation, whose draw covers the whole batch.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value

from ccst_tpu_torch.data import jigsaw
from ccst_tpu_torch.ops import fft_aug
from ccst_tpu_torch.ops.image import eval_transform, sample_train_transform, train_transform

State = Dict[str, torch.Tensor]
Draws = Dict[str, Any]
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


def _masked_mean(per_example: torch.Tensor, mask: torch.Tensor,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over the real rows; ``count`` is their number when it is not
    this batch's own (a data group's rows)."""
    count = torch.sum(mask) if count is None else count
    return torch.sum(per_example * mask) / torch.clamp(count, min=1.0)


def _masked_percentile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """``percentile(x[mask > 0], q)`` ('linear') with a fixed shape: padding
    sorts to +inf and the rank is q/100 * (n_valid - 1), as in ``ccst_tpu``."""
    xs = torch.sort(torch.where(mask > 0, x, torch.full_like(x, float("inf")))).values
    n = torch.sum(mask)
    r = (q / 100.0) * torch.clamp(n - 1.0, min=0.0)
    lo = torch.clamp(torch.floor(r).long(), 0, x.shape[0] - 1)
    hi = torch.minimum(torch.clamp(lo + 1, min=0), torch.clamp(n.long() - 1, min=0))
    w = (r - lo).to(x.dtype)
    # gathers, not xs[lo]: a 0-d index tensor is read on the host, which vmap refuses
    x_lo, x_hi = xs.gather(0, lo.view(1))[0], xs.gather(0, hi.view(1))[0]
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


def _rsc_logits(model, state: State, images, labels, n_classes: int, mask_valid,
                gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """RSC's muted logits (utils/rsc_utils.py:32-75) from ONE backbone forward
    (BN statistics update once): mute the features of the top third of the
    head's gradient per sample, unmute the samples in the bottom two thirds of
    the prediction change. ``mask_valid`` keeps padding out of the batch
    percentile; ``gather`` (a batch split over a data group) joins the rows'
    changes and masks, so that the percentile is the whole batch's."""
    feats = forward(model, state, images, True, return_features=True)
    # F.one_hot reads its input's max on the host, which vmap refuses
    onehot = (labels.long()[:, None] == torch.arange(n_classes, device=labels.device)
              ).to(feats.dtype)
    # d/df sum(head(f) * onehot) of the linear head: onehot @ W, the product
    # autograd forms for it, written out (it runs under the step's transforms)
    name = "class_classifier" if "class_classifier.weight" in state else "classifier"
    g = onehot @ state[f"{name}.weight"].detach()
    pct_f = torch.quantile(g, RSC_PERCENT / 100.0, dim=1, keepdim=True)
    mask_f = (g < pct_f).to(feats.dtype)
    with torch.no_grad():
        s = F.softmax(_head(state, feats), dim=1)
        s_muted = F.softmax(_head(state, feats * mask_f), dim=1)
        changes = torch.sum(s * onehot, dim=1) - torch.sum(s_muted * onehot, dim=1)
        every, valid = ((changes, mask_valid) if gather is None
                        else (gather(changes), gather(mask_valid)))
        pct_b = _masked_percentile(every.float(), valid, RSC_PERCENT).to(changes.dtype)
    mask_b = (changes < pct_b).to(feats.dtype)[:, None]
    return _head(state, feats * torch.maximum(mask_f, mask_b))


def _prox_term(params: State, server: State) -> torch.Tensor:
    return sum(torch.sum(torch.square(p.float() - server[k].float())) for k, p in params.items())


class TrainStep:
    """``draw(generator, batch) -> draws`` on the host and the pure
    ``apply(state, server_state, batch, draws, step_idx) -> (state,
    StepMetrics)``; calling it runs both."""

    def __init__(self, draw: Callable[[torch.Generator, Dict[str, torch.Tensor]], Draws],
                 apply: Callable):
        self.draw, self.apply = draw, apply

    def __call__(self, state: State, server_state: State, batch, generator: torch.Generator,
                 step_idx: int) -> Tuple[State, StepMetrics]:
        return self.apply(state, server_state, batch, self.draw(generator, batch), step_idx)


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
    data_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    data_gather: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    data_size: int = 1,
) -> TrainStep:
    """One client-local SGD step (module docstring). ``data_reduce`` sums a
    tensor over a data group of ``data_size`` ranks, each holding its share of
    the batch; ``data_gather`` concatenates a tensor's rows over it."""
    dg = dg_method.lower()
    is_prox = mode.lower() == "fedprox"
    param_keys, buffer_keys = model_keys(model)
    n_mix = getattr(model, "n_mix", 0) if dg == "mixstyle" else 0
    reduce = data_reduce if data_reduce is not None else (lambda t: t)

    def draw(generator: torch.Generator, batch) -> Draws:
        n, h, w, _ = batch["images"].shape
        draws: Draws = {}
        if dg == "jigsaw":
            draws["orders"] = jigsaw.sample_orders(generator, n, jigsaw_n_classes,
                                                   bias_whole_image)
        if dg == "feddg":
            draws["picks"], draws["ratios"] = fft_aug.sample_feddg_draws(
                generator, n, batch["amp_bank"].shape[0])
        else:
            draws["crop"] = sample_train_transform(generator, n, h, w, min_scale, max_scale)
        if n_mix:
            draws["mix"] = [model.mix.sample(generator, n) for _ in range(n_mix)]
        return draws

    def prepare(images, draws: Draws):
        return train_transform(draws["crop"], images, image_size, min_scale, max_scale)

    def losses(params: State, buffers: State, old_buffers: State, batch, draws: Draws, mask,
               labels, count):
        """(loss, (logits for the metrics, jig correct count)); ``buffers``
        (copies of ``old_buffers``) take the forward's new running
        statistics."""
        state = {**params, **buffers}
        jig_corr = torch.zeros((), device=mask.device)
        if dg == "jigsaw":
            # the reference's model reads the permuted grid image for BOTH heads
            # (fed_run.py:58); the grid goes through the train transform
            perms = torch.from_numpy(jigsaw.permutation_set(jigsaw_n_classes))
            jig_images = jigsaw.tile_and_permute(batch["images"], draws["orders"], perms)
            jig_labels = draws["orders"].to(mask.device, non_blocking=True)
            logits, jig_logits = forward(model, state, prepare(jig_images, draws), True)
            loss = (_masked_mean(cross_entropy(logits, labels), mask, count)
                    + jig_weight * _masked_mean(cross_entropy(jig_logits, jig_labels), mask,
                                                count))
            jig_corr = torch.sum((jig_logits.argmax(1) == jig_labels).float() * mask)
        elif dg == "rsc":
            images = prepare(batch["images"], draws)
            logits = _rsc_logits(model, state, images, labels, n_classes, mask, data_gather)
            loss = _masked_mean(cross_entropy(logits, labels), mask, count)
        else:  # no_DG / mixstyle
            kw = {"mix_draws": draws["mix"]} if n_mix else {}
            logits = forward(model, state, prepare(batch["images"], draws), True, **kw)
            loss = _masked_mean(cross_entropy(logits, labels), mask, count)
        return loss, (logits, jig_corr)

    def feddg_grads(params: State, buffers: State, old_buffers: State, batch, draws: Draws,
                    mask, labels, count):
        """FedDG's loss l_inner(p) + l_outer(p - a clip(grad l_inner)) and its
        gradient. The inner gradient is a constant (FOMAML, fed_run.py:110), so
        the gradient is grad l_inner(p) + grad l_outer at the fast weights:
        two gradient transforms side by side, neither nested in the other."""
        images = eval_transform(batch["images"], image_size)
        freq = eval_transform(fft_aug.feddg_augment(batch["images"], batch["amp_bank"],
                                                    draws["picks"], draws["ratios"], L=0.0),
                              image_size)

        def inner(p: State, bufs: State):
            lg = forward(model, {**p, **bufs}, images, True)
            return _masked_mean(cross_entropy(lg, labels), mask, count), lg

        def outer(fast: State, bufs: State):
            lg = forward(model, {**fast, **bufs}, freq, True)
            return _masked_mean(cross_entropy(lg, labels), mask, count)

        g_in, (l_inner, logits) = grad_and_value(inner, has_aux=True)(params, buffers)
        g_in = {k: reduce(g) for k, g in g_in.items()}
        fast = {k: p - meta_step_size * torch.clamp(g_in[k], -clip_value, clip_value)
                for k, p in params.items()}
        # the outer pass's statistics are discarded: it runs on copies
        outer_buffers = {k: v.clone() for k, v in old_buffers.items()}
        g_out, l_outer = grad_and_value(outer)(fast, outer_buffers)
        return ({k: g_in[k] + reduce(g_out[k]) for k in params}, l_inner + l_outer,
                (logits, torch.zeros((), device=mask.device)))

    def apply(state: State, server_state: State, batch, draws: Draws, step_idx: int
              ) -> Tuple[State, StepMetrics]:
        mask = batch["mask"].float()
        labels = batch["labels"]
        count = reduce(torch.sum(mask)) if data_reduce is not None else None
        params = {k: state[k] for k in param_keys}
        buffers_before = {k: state[k] for k in buffer_keys}
        buffers = {k: v.clone() for k, v in buffers_before.items()}

        def prox(params: State):
            return (mu / 2.0) * _prox_term(params, server_state)

        with torch.enable_grad():
            if dg == "feddg":
                grads, loss, (logits, jig_corr) = feddg_grads(
                    params, buffers, buffers_before, batch, draws, mask, labels, count)
            else:
                grads, (loss, (logits, jig_corr)) = grad_and_value(losses, has_aux=True)(
                    params, buffers, buffers_before, batch, draws, mask, labels, count)
                grads = {k: reduce(g) for k, g in grads.items()}
            if is_prox and step_idx > 0:
                # after the group sum: every rank of a data group adds the
                # whole term once, and its share to the loss that is summed
                g_prox, l_prox = grad_and_value(prox)(params)
                grads = {k: g + g_prox[k] for k, g in grads.items()}
                loss = loss + l_prox / data_size
        with torch.no_grad():
            n_valid = torch.sum(mask) if count is None else count
            any_valid = n_valid > 0
            new_state = {k: torch.where(any_valid, p - lr * grads[k].to(p.dtype), p)
                         for k, p in params.items()}
            for k in buffer_keys:
                new_state[k] = torch.where(any_valid, buffers[k], buffers_before[k])
            active = any_valid.float()
            metrics = StepMetrics(
                loss=reduce(loss.detach()) * active,
                correct=reduce(torch.sum((logits.argmax(1) == labels).float() * mask)),
                count=n_valid,
                jig_correct=reduce(jig_corr.detach()),
                active=active,
            )
        return {k: new_state[k] for k in state}, metrics

    return TrainStep(draw, apply)


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
