"""Client-parallel federated training: every client's local step at once.

Counterpart of ``ccst_tpu/parallel/fed_mesh.py``. The reference trains its
clients one after another (fed_run.py:663-673); here the clients' states are
stacked on a leading axis and one local step of every client is one
``torch.func.vmap`` of the pure step (``federated/train_ops.py``): in-dims 0
for the states, the batch and the draws, none for the server state, the
FedDG amplitude bank and the step index. A conv with a batched weight becomes
one grouped conv (``groups`` = clients), C-fold wider for the same launches.

A mesh is a grid of ``torch.distributed`` ranks, one process a rank (torch's
idiom, where JAX's mesh is a grid of local devices): :class:`FedMesh` of
``client_shards x data_shards`` ranks, rank ``c * data_shards + d``, with a
``client`` group (the ranks of one data index, over which the client states
are gathered) and a ``data`` group (the ranks that split one block of
clients' batches, over which :class:`DataGroup` sums gradients, BatchNorm
batch statistics and row counts inside the step, and gathers the rows that
RSC and MixStyle mix across the batch). A single process that asks
for more than one rank raises ``SystemExit`` naming the launch.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ccst_tpu_torch.federated.aggregate import aggregate
from ccst_tpu_torch.parallel import multihost

State = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# stacking
# ---------------------------------------------------------------------------


def stack_trees(trees: Sequence[Any]) -> Any:
    """Stack equal-structured trees (dicts, lists, tuples of tensors) on a
    new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees(list(xs)) for xs in zip(*trees))
    return torch.stack(list(trees))


def map_tree(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def unstack_states(stacked: State, n: int) -> List[State]:
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def client_seed(seed: int, round_idx: int, client: int) -> int:
    """The seed of client ``client``'s generator in round ``round_idx`` of a
    parallel run: ``(seed * 100003 + round_idx) * 1000 + client`` (the
    sequential runner's round seed, one stream a client). Within a step the
    clients draw in client order; a client's draws depend on nothing but its
    own stream, so a multi-process run draws what a single process draws."""
    return (seed * 100003 + round_idx) * 1000 + client


def client_generators(seed: int, round_idx: int, clients: Sequence[int]
                      ) -> List[torch.Generator]:
    return [torch.Generator().manual_seed(client_seed(seed, round_idx, c)) for c in clients]


# ---------------------------------------------------------------------------
# the mesh: a grid of ranks
# ---------------------------------------------------------------------------


class FedMesh:
    """(client, data) grid of ranks over the whole process group."""

    def __init__(self, client_shards: int, data_shards: int = 1):
        need = client_shards * data_shards
        have = multihost.world_size()
        if have != need:
            raise SystemExit(
                f"a (client {client_shards}, data {data_shards}) mesh needs {need} ranks, have "
                f"{have}: launch {need} processes with --coordinator HOST:PORT --num-procs "
                f"{need} --proc-id K (K = 0..{need - 1}), one rank a device")
        self.client_shards, self.data_shards = client_shards, data_shards
        self.client_index, self.data_index = divmod(multihost.rank(), data_shards)
        self.client_group = self.data_group = None
        if need > 1:
            # every rank creates every group, in the same order
            for d in range(data_shards):
                g = dist.new_group([c * data_shards + d for c in range(client_shards)])
                if d == self.data_index:
                    self.client_group = g
            for c in range(client_shards):
                g = dist.new_group([c * data_shards + d for d in range(data_shards)])
                if c == self.client_index:
                    self.data_group = g


class _GroupSum(torch.autograd.Function):
    """Sum over a data group, differentiable (the gradient of a sum over
    ranks is the sum of the ranks' gradients) and batched under vmap: the
    rule reduces the stacked tensor, client by client across the ranks."""

    @staticmethod
    def forward(x: torch.Tensor, group) -> torch.Tensor:
        return multihost.all_reduce_sum(x.detach().clone(), group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _GroupSum.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _GroupSum.apply(x, group), in_dims[0]


class _GroupGather(torch.autograd.Function):
    """The rows of every rank of a data group, concatenated along ``dim`` in
    rank order (the client's whole batch); differentiable (a rank's gradient
    is its own rows of the gathered tensor's gradient summed over the ranks)
    and batched under vmap (the rule gathers along the rows of the stacked
    tensor, client by client)."""

    @staticmethod
    def forward(x: torch.Tensor, group, dim: int) -> torch.Tensor:
        return torch.cat(multihost.all_gather(x.detach(), group), dim=dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.group, ctx.dim = inputs
        ctx.rows = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        total = _GroupSum.apply(g.contiguous(), ctx.group)
        mine = dist.get_rank(ctx.group) * ctx.rows
        return total.narrow(ctx.dim, mine, ctx.rows), None, None

    @staticmethod
    def vmap(info, in_dims, x, group, dim):
        if in_dims[0] is None:
            return _GroupGather.apply(x, group, dim), None
        return _GroupGather.apply(x.movedim(in_dims[0], 0), group, dim + 1), 0


class DataGroup:
    """The ranks that split each client's batch: ``reduce`` sums a tensor over
    them inside the step, ``gather`` concatenates its rows (the client's
    whole batch, for what mixes rows: RSC's batch percentile, MixStyle's
    permutation); ``rows(b)`` is this rank's slice of ``b`` rows."""

    def __init__(self, group):
        self.group, self.size = group, dist.get_world_size(group)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return _GroupSum.apply(t, self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return _GroupGather.apply(t, self.group, 0)

    def rows(self, b: int) -> slice:
        return multihost.group_rows(b, self.group)


class GroupBatchNorm(nn.Module):
    """Train-mode BatchNorm over a batch split across a data group, under the
    names and buffers of ``nn.BatchNorm2d`` / ``1d``: the per-channel sums of x
    and x^2 and the row count are summed over the group, the variance is
    mean(x^2) - mean^2 as flax's BatchNorm forms it, and the running
    statistics follow torch's momentum with the unbiased variance of the
    group's batch. Eval mode is ``F.batch_norm`` on the running statistics."""

    def __init__(self, bn: nn.modules.batchnorm._BatchNorm, data: DataGroup):
        super().__init__()
        self.eps, self.momentum, self.data = bn.eps, bn.momentum, data
        self.weight, self.bias = bn.weight, bn.bias
        self.register_buffer("running_mean", bn.running_mean)
        self.register_buffer("running_var", bn.running_var)
        self.register_buffer("num_batches_tracked", bn.num_batches_tracked)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        n_local = torch.full((1,), float(x.numel() // x.shape[1]), device=x.device)
        sums = self.data.reduce(torch.cat([xf.sum(dims), (xf * xf).sum(dims), n_local]))
        c = x.shape[1]
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean.detach())
            self.running_var.copy_((1 - m) * self.running_var
                                   + m * var.detach() * n / torch.clamp(n - 1, min=1.0))
            self.num_batches_tracked.add_(1)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


def with_data_group(model: nn.Module, data: DataGroup) -> nn.Module:
    """``model`` for a batch split over ``data``: every BatchNorm swapped for
    :class:`GroupBatchNorm`, every MixStyle mixing with the statistics of
    the client's whole batch (``data.gather``); same state-dict keys, the
    model's own tensors shared."""
    import copy

    from ccst_tpu_torch.models.layers import MixStyle

    out = copy.copy(model)
    out._modules = dict(model._modules)
    for name, child in model.named_children():
        if isinstance(child, nn.modules.batchnorm._BatchNorm):
            out._modules[name] = GroupBatchNorm(child, data)
        elif isinstance(child, MixStyle):
            mix = copy.copy(child)
            mix.gather = data.gather
            out._modules[name] = mix
        else:
            out._modules[name] = with_data_group(child, data)
    return out


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


class ParallelFedTrainer:
    """Drives stacked client states through vmapped local steps and the
    aggregation. The host feeds one stacked batch (C, B, ...) a local step;
    clients with shorter epochs contribute masked no-op steps."""

    def __init__(self, train_step, mode: str, weights: Sequence[float],
                 n_clients: Optional[int] = None):
        """``weights`` are every client's; ``n_clients`` the clients this
        trainer steps (default: all)."""
        self.train_step, self.mode, self.weights = train_step, mode, list(weights)
        self.n_local = len(self.weights) if n_clients is None else n_clients

    def step(self, states: State, server: State, batch: Dict[str, torch.Tensor], draws,
             step_idx: int):
        """One local step of every client: (states, StepMetrics of (C,))."""
        batch_dims = {k: (None if k == "amp_bank" else 0) for k in batch}
        vstep = torch.func.vmap(self.train_step.apply, in_dims=(0, None, batch_dims, 0, None),
                                randomness="error")
        return vstep(states, server, batch, draws, step_idx)

    def draw(self, generators: Sequence[torch.Generator], batch: Dict[str, torch.Tensor],
             device: torch.device, data: Optional[DataGroup] = None):
        """Every client's draws for a stacked batch, client after client from
        its own generator, stacked and on ``device``. With a data group the
        draws are those of the whole batch (``data.size`` times this rank's
        rows), and this rank keeps its rows of each per-row draw."""
        per = []
        for ci, gen in enumerate(generators):
            one = {k: (v if k == "amp_bank" else v[ci]) for k, v in batch.items()}
            if data is None:
                per.append(self.train_step.draw(gen, one))
                continue
            b = one["images"].shape[0] * data.size
            whole = dict(one, images=torch.empty((b,) + one["images"].shape[1:], device="meta"))
            rows = data.rows(b)
            per.append(map_tree(lambda t: t[rows] if t.dim() else t,
                                self.train_step.draw(gen, whole)))
        return map_tree(lambda t: t.to(device, non_blocking=True), stack_trees(per))

    def run_epoch(self, states: State, server: State, batches: Iterator[Dict[str, torch.Tensor]],
                  generators: Sequence[torch.Generator], n_steps: Optional[int] = None,
                  data: Optional[DataGroup] = None) -> Tuple[State, Dict[str, Any]]:
        """One local epoch of every client (``n_steps`` of them when given).
        The metrics are summed over each client's real steps only, with one
        wait for the device at the end; ``loader_wait_seconds`` is the host's
        time blocked on the batches."""
        device = next(iter(states.values())).device
        sums, wait, step_idx = [], 0.0, 0
        it = iter(batches)
        while n_steps is None or step_idx < n_steps:
            t0 = time.perf_counter()
            batch = next(it, None)
            wait += time.perf_counter() - t0
            if batch is None:
                break
            draws = self.draw(generators, batch, device, data)
            states, m = self.step(states, server, batch, draws, step_idx)
            sums.append(torch.stack([m.loss, m.correct, m.count, m.active]))
            step_idx += 1
        if sums:
            loss, correct, count, active = torch.stack(sums).double().sum(0).cpu().numpy()
        else:
            loss = correct = count = active = np.zeros(self.n_local)
        return states, {"loss_sum": loss, "correct": correct, "count": count, "active": active,
                        "train_loss": loss / np.maximum(active, 1.0),
                        "train_acc": correct / np.maximum(count, 1.0),
                        "loader_wait_seconds": wait, "steps": step_idx}

    def communicate(self, stacked_states: State) -> Tuple[State, List[State]]:
        """Aggregate -> (server state, new client states), the sequential
        runner's ``aggregate`` on the unstacked clients."""
        return aggregate(self.mode, unstack_states(stacked_states, len(self.weights)),
                         self.weights)


def stack_step_batches(client_batch_iters: List, to_batch_dict: Callable,
                       n_steps: Optional[int] = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Zip the clients' batch iterators into stacked (C, B, ...) batch dicts,
    padding an exhausted client with zero-mask copies of its last batch: until
    every client's epoch has run, or for exactly ``n_steps`` steps (every rank
    of a multi-process run takes the same number of collective steps)."""
    iters = [iter(it) for it in client_batch_iters]
    done = [False] * len(iters)
    last: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(iters)
    step = 0
    while n_steps is None or step < n_steps:
        batches = []
        for i, it in enumerate(iters):
            if not done[i]:
                b = next(it, None)
                if b is None:
                    done[i] = True
                else:
                    last[i] = to_batch_dict(b)
            if done[i]:
                if last[i] is None:
                    raise ValueError(f"client {i} has no batches at all")
                batches.append({**last[i], "mask": torch.zeros_like(last[i]["mask"])})
            else:
                batches.append(last[i])
        if n_steps is None and all(done):
            return
        yield stack_trees(batches)
        step += 1
