"""Stochastic Weight Averaging + SWAD-style automatic window selection.

Port of ``ccst_tpu/utils/swa.py`` (the reference's utils/swa_utils.py:
``AveragedModel`` / ``update_bn`` / ``SWALR``; utils/autoswa.py: ``IIDMax`` /
``LossValley``). In the reference these are dead code, never imported by
fed_run, but part of the framework's surface. Weights are torch state dicts
(or nested dicts of tensors): the average is a running mean leaf by leaf, and
BatchNorm re-estimation is a forward sweep collecting batch statistics.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, Optional

import numpy as np
import torch

Tree = Any


def _map(fn: Callable, *trees: Tree) -> Tree:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


# ---------------------------------------------------------------------------
# AveragedModel equivalent (swa_utils.py:23-...)
# ---------------------------------------------------------------------------


@dataclass
class SWAState:
    avg_params: Tree
    n_averaged: int = 0
    start_step: int = 0
    end_step: int = 0
    end_loss: float = float("inf")

    def copy(self) -> "SWAState":
        return SWAState(
            avg_params=_map(lambda x: x.clone(), self.avg_params),
            n_averaged=self.n_averaged,
            start_step=self.start_step,
            end_step=self.end_step,
            end_loss=self.end_loss,
        )


def swa_init(params: Tree, step: int = 0) -> SWAState:
    return SWAState(
        avg_params=_map(lambda x: x.detach().clone(), params),
        n_averaged=1,
        start_step=step,
        end_step=step,
    )


def swa_update(state: SWAState, params: Tree, step: int = 0) -> SWAState:
    """Equal-weight running mean: avg += (p - avg) / (n + 1)."""
    n = state.n_averaged
    new_avg = _map(lambda a, p: a + (p.detach().to(a.dtype) - a) / (n + 1),
                   state.avg_params, params)
    return SWAState(
        avg_params=new_avg,
        n_averaged=n + 1,
        start_step=state.start_step,
        end_step=step,
        end_loss=state.end_loss,
    )


def swa_merge(a: SWAState, b: SWAState) -> SWAState:
    """Merge two averaged segments with their sample counts (used by the
    LossValley window extension, autoswa.py:105-121)."""
    na, nb = a.n_averaged, b.n_averaged
    total = na + nb
    merged = _map(lambda x, y: (x * na + y.to(x.dtype) * nb) / total,
                  a.avg_params, b.avg_params)
    return SWAState(
        avg_params=merged,
        n_averaged=total,
        start_step=min(a.start_step, b.start_step),
        end_step=max(a.end_step, b.end_step),
        end_loss=b.end_loss,
    )


@torch.no_grad()
def swa_update_bn(model: torch.nn.Module, params: Dict[str, torch.Tensor], loader,
                  image_size: int, device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """Recompute the BatchNorm running statistics of the averaged weights by
    streaming the training data once (swa_utils.update_bn equivalent), as
    ``ccst_tpu``'s does: each batch (``runtime.batch_dict``, the eval
    transform) runs once in train mode from fresh statistics (mean 0,
    variance 1, so each result is the momentum blend of those and the
    batch's), and the results are averaged over the batches. Returns the
    fresh ``running_mean`` / ``running_var`` leaves by state-dict key."""
    from ccst_tpu_torch.federated.runtime import batch_dict
    from ccst_tpu_torch.federated.train_ops import forward, model_keys
    from ccst_tpu_torch.ops.image import eval_transform

    names, buffers = model_keys(model)
    stat_keys = [k for k in buffers if k.endswith(("running_mean", "running_var"))]
    dev = torch.device(device)
    weights = {k: params[k].to(dev) for k in names}
    sums: Optional[Dict[str, torch.Tensor]] = None
    n = 0
    for batch in loader:
        images = eval_transform(batch_dict(batch, dev)["images"], image_size)
        fresh = {k: (torch.zeros_like(params[k]) if k.endswith("running_mean")
                     else torch.ones_like(params[k])).to(dev, torch.float32) for k in stat_keys}
        counters = {k: torch.zeros((), dtype=torch.long, device=dev)
                    for k in buffers if k not in fresh}
        forward(model, {**weights, **fresh, **counters}, images, True)
        sums = fresh if sums is None else {k: sums[k] + fresh[k] for k in stat_keys}
        n += 1
    if sums is None:
        return {}
    return {k: v / n for k, v in sums.items()}


def swa_lr_schedule(base_lr: float, swa_lr: float, anneal_steps: int) -> Callable[[int], float]:
    """SWALR: linear anneal from base_lr to swa_lr over anneal_steps, then
    constant (swa_utils.SWALR equivalent)."""

    def lr(step: int) -> float:
        if step >= anneal_steps:
            return swa_lr
        t = step / max(anneal_steps, 1)
        return base_lr + (swa_lr - base_lr) * t

    return lr


# ---------------------------------------------------------------------------
# AutoSWA policies (autoswa.py)
# ---------------------------------------------------------------------------


class IIDMax:
    """SWA window starting at the best-val checkpoint, final pick by best SWA
    val accuracy (autoswa.py:15-46)."""

    def __init__(self):
        self.iid_max_acc = -1.0
        self.swa_max_acc = -1.0
        self.avg: Optional[SWAState] = None
        self.final: Optional[SWAState] = None

    def update(self, params: Tree, val_acc: float, swa_val_acc_fn, step: int) -> None:
        if val_acc > self.iid_max_acc:
            self.iid_max_acc = val_acc
            self.avg = swa_init(params, step)
        else:
            assert self.avg is not None
            self.avg = swa_update(self.avg, params, step)
        swa_acc = swa_val_acc_fn(self.avg.avg_params)
        if swa_acc > self.swa_max_acc:
            self.swa_max_acc = swa_acc
            self.final = self.avg.copy()

    def get_final(self) -> Optional[SWAState]:
        return self.final


class LossValley:
    """SWAD: pick the averaging window by detecting the validation-loss
    valley (autoswa.py:47-160). Segments arrive as already-averaged
    ``SWAState``s with ``end_loss`` set."""

    def __init__(self, n_converge: int = 3, n_tolerance: int = 6,
                 tolerance_ratio: float = 0.3):
        self.n_converge = n_converge
        self.n_tolerance = n_tolerance
        self.tolerance_ratio = tolerance_ratio
        self.converge_q: Deque[SWAState] = deque(maxlen=n_converge)
        self.smooth_q: Deque[SWAState] = deque(maxlen=n_tolerance)
        self.final: Optional[SWAState] = None
        self.converge_step: Optional[int] = None
        self.dead_valley = False
        self.threshold: Optional[float] = None

    @property
    def is_converged(self) -> bool:
        return self.converge_step is not None

    def _smooth_min(self, idx: int) -> float:
        return min(s.end_loss for s in list(self.smooth_q)[idx:])

    def update(self, segment: SWAState, val_loss: float) -> None:
        if self.dead_valley:
            return
        frozen = segment.copy()
        frozen.end_loss = val_loss
        self.converge_q.append(frozen)
        self.smooth_q.append(frozen)

        if not self.is_converged:
            if len(self.converge_q) < self.n_converge:
                return
            losses = [s.end_loss for s in self.converge_q]
            min_idx = int(np.argmin(losses))
            if min_idx == 0:
                self.converge_step = self.converge_q[0].end_step
                self.final = self.converge_q[0].copy()
                self.threshold = float(np.mean(losses)) * (1.0 + self.tolerance_ratio)
                if self.n_tolerance < self.n_converge:
                    for s in list(self.converge_q)[1 : 1 + self.n_converge - self.n_tolerance]:
                        self.final = swa_merge(self.final, s)
                elif self.n_tolerance > self.n_converge:
                    converge_idx = self.n_tolerance - self.n_converge
                    q = list(self.smooth_q)[: converge_idx + 1]
                    start_idx = 0
                    for i in reversed(range(len(q))):
                        if q[i].end_loss > self.threshold:
                            start_idx = i + 1
                            break
                    for s in q[start_idx + 1 :]:
                        self.final = swa_merge(self.final, s)
            return

        if self.smooth_q[0].end_step < self.converge_step:
            return
        if self._smooth_min(0) > self.threshold:
            self.dead_valley = True
            return
        self.final = swa_merge(self.final, self.smooth_q[0])

    def get_final(self) -> Optional[SWAState]:
        if not self.is_converged:
            return self.converge_q[-1] if self.converge_q else None
        if not self.dead_valley and self.smooth_q:
            self.smooth_q.popleft()
            while self.smooth_q:
                if self._smooth_min(0) > self.threshold:
                    break
                self.final = swa_merge(self.final, self.smooth_q.popleft())
        return self.final
