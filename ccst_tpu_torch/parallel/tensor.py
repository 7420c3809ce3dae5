"""Parameter (tensor) sharding over a ``model`` group of ranks.

Counterpart of ``ccst_tpu/parallel/tensor.py``. The reference's only
intra-model parallelism is ModelParallelResNet50, a two-GPU pipeline split by
hand (nets/resnet.py:235-260) and disabled in its factory; ``ccst_tpu``
annotates parameters with shardings over a ``model`` mesh axis and lets
GSPMD partition the convs. Here a (data, model) grid of ranks
(:func:`make_dp_tp_mesh`) holds the same policy explicitly:

  - :func:`param_spec`: split the OUTPUT-channel dimension of a conv or dense
    weight (dim 0 of an OIHW conv weight and of a ``Linear`` weight) when the
    leaf has ndim >= 2, that dimension is divisible by the ``model`` axis and
    at least ``min_dim``; replicate biases, norm leaves and everything small.
  - :func:`with_tensor_parallel`: a conv or dense layer with a split weight
    computes its slice of the output channels, and an all-gather along the
    channels, differentiable, restores the replicated activation: its
    backward hands each rank its own slice of the gradient, and the layer's
    input sums the ranks' input gradients (each rank's slice reaches the
    input through its own weights only). The bias joins after the gather.
    Activations stay replicated, as ``ccst_tpu``'s do.
  - :func:`shard_batch` gives a data rank its rows; the loss is each data
    rank's mean over its rows, so the gradients are averaged over the data
    group (:func:`data_mean`), as ``ccst_tpu``'s mean loss over the global
    batch implies.

cuDNN and cuBLAS run the convs and products here: no TPU kernel lies on this
path in either package. Collectives go through ``parallel/multihost.py``
(through the host on gloo).
"""
from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ccst_tpu_torch.parallel import multihost

Tree = Dict[str, torch.Tensor]


class DpTpMesh:
    """A (data, model) grid of the world's first ``n_data * n_model`` ranks,
    rank = d * n_model + m: ``model_group`` holds the ranks of this rank's
    data index (they split the parameters), ``data_group`` those of its model
    index (they split the batch)."""

    def __init__(self, n_data: int, n_model: int):
        need = n_data * n_model
        have = multihost.world_size()
        if have < need:
            raise ValueError(f"need {need} devices, have {have}")
        self.shape = {"data": n_data, "model": n_model}
        self.data_index, self.model_index = divmod(multihost.rank(), n_model)
        self.data_group = self.model_group = None
        if have > 1:
            # every rank of the world creates every group, in the same order
            for d in range(n_data):
                g = dist.new_group([d * n_model + m for m in range(n_model)])
                if d == self.data_index:
                    self.model_group = g
            for m in range(n_model):
                g = dist.new_group([d * n_model + m for d in range(n_data)])
                if m == self.model_index:
                    self.data_group = g


def make_dp_tp_mesh(n_data: int, n_model: int) -> DpTpMesh:
    return DpTpMesh(n_data, n_model)


def param_spec(path: str, leaf: torch.Tensor, axis_size: int, min_dim: int = 128) -> Tuple:
    """The leaf's partition, as ``ccst_tpu``'s ``PartitionSpec``: ``"model"``
    at the split dimension (output channels, dim 0 in torch's layouts), or
    ``()`` for a replicated leaf."""
    if leaf.ndim >= 2 and leaf.shape[0] % axis_size == 0 and leaf.shape[0] >= min_dim:
        return ("model",) + (None,) * (leaf.ndim - 1)
    return ()


def _split(t: torch.Tensor, mesh: DpTpMesh) -> torch.Tensor:
    return t.chunk(mesh.shape["model"], 0)[mesh.model_index]


def shard_params(params: Tree, mesh: DpTpMesh, min_dim: int = 128) -> Tree:
    """This rank's leaves under :func:`param_spec`: its block of the output
    channels of every split leaf, every other leaf whole."""
    n = mesh.shape["model"]
    return {k: _split(v, mesh) if param_spec(k, v, n, min_dim) else v
            for k, v in params.items()}


def unshard_params(params: Tree, full: Tree, mesh: DpTpMesh, min_dim: int = 128) -> Tree:
    """The whole leaves from every rank's :func:`shard_params` slices (of
    parameters or their gradients) of leaves shaped as in ``full``: the split
    leaves gathered over the model group, in rank order."""
    n = mesh.shape["model"]
    return {k: torch.cat(multihost.all_gather(v, mesh.model_group), 0)
            if param_spec(k, full[k], n, min_dim) and n > 1 else v
            for k, v in params.items()}


def shard_batch(batch: Tree, mesh: DpTpMesh) -> Tree:
    """Batch-dim data parallelism: this data rank's rows of every leaf with a
    batch dimension."""
    n, d = mesh.shape["data"], mesh.data_index

    def rows(x):
        if x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over {n} data ranks")
        per = x.shape[0] // n
        return x[d * per:(d + 1) * per]

    return {k: rows(v) for k, v in batch.items()}


def data_mean(tensors: Sequence[torch.Tensor], mesh: DpTpMesh) -> List[torch.Tensor]:
    """The tensors (gradients, the loss) averaged over the data group."""
    if mesh.shape["data"] == 1:
        return list(tensors)
    return multihost.all_reduce_mean(tensors, mesh.data_group)


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the model
    group (each rank's output slice reaches the input through its weights
    only)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return multihost.all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _GatherChannels(torch.autograd.Function):
    """Every rank's output channels joined along ``dim`` in rank order; the
    backward is this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, group, dim: int) -> torch.Tensor:
        ctx.dim, ctx.width = dim, y.shape[dim]
        ctx.index = dist.get_rank(group)
        return torch.cat(multihost.all_gather(y, group), dim=dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, None


class _ChannelSplit(nn.Module):
    """A conv or dense layer whose weight holds this rank's output channels;
    its state-dict keys are the layer's own."""

    def __init__(self, layer: nn.Module, mesh: DpTpMesh):
        super().__init__()
        self.group = mesh.model_group
        self.conv = (dict(stride=layer.stride, padding=layer.padding, dilation=layer.dilation)
                     if isinstance(layer, nn.Conv2d) else None)
        self.weight = nn.Parameter(_split(layer.weight.detach(), mesh))
        self.bias = layer.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _SumGrads.apply(x, self.group)
        if self.conv is not None:
            y = _GatherChannels.apply(F.conv2d(x, self.weight, None, **self.conv), self.group, 1)
            return y if self.bias is None else y + self.bias.view(1, -1, 1, 1)
        y = _GatherChannels.apply(F.linear(x, self.weight), self.group, x.dim() - 1)
        return y if self.bias is None else y + self.bias


def with_tensor_parallel(model: nn.Module, mesh: DpTpMesh, min_dim: int = 128) -> nn.Module:
    """``model`` with every ``Conv2d`` (ungrouped) and ``Linear`` whose weight
    :func:`param_spec` splits computing its slice of the output channels
    (module docstring). The state dict keeps the model's keys, with the split
    weights' slices (:func:`shard_params` of the model's state dict); every
    other tensor is the model's own."""
    out = copy.copy(model)
    out._modules = dict(model._modules)
    n = mesh.shape["model"]
    for name, child in model.named_children():
        if (n > 1 and (isinstance(child, nn.Linear) or (isinstance(child, nn.Conv2d)
                                                       and child.groups == 1))
                and param_spec(name, child.weight, n, min_dim)):
            out._modules[name] = _ChannelSplit(child, mesh)
        else:
            out._modules[name] = with_tensor_parallel(child, mesh, min_dim)
    return out
