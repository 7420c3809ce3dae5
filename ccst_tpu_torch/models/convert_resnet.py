"""Weights across packages and from torchvision.

Counterpart of ``ccst_tpu/models/convert_resnet.py``, plus the carry between
the two packages:

- :func:`from_jax` turns ``ccst_tpu``'s (params, batch_stats) numpy trees into
  a state dict of this package's zoo (``models/classifiers.py`` names its
  modules as the flax tree does): conv HWIO -> OIHW, Dense (in, out) ->
  (out, in), ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``, and ``num_batches_tracked`` 0 beside
  every running statistic (flax has none);
- :func:`to_jax` is its inverse;
- :func:`convert_torchvision_resnet` / :func:`load_imagenet_resnet` overlay a
  torchvision ResNet state dict on an initial state by a direct key map
  (``layer{L}.{B}.conv{k}`` -> ``layer{L}_{B}.Conv_{k-1}``,
  ``downsample.0/1`` -> the block's last ``Conv_n`` / ``bn_down``); the head
  ``fc.*`` is skipped like the reference's ``strict=False`` load
  (nets/resnet.py:326-345).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _kernel_to_torch(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    return a.T  # Dense (in, out) -> (out, in)


def from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> StateDict:
    """``ccst_tpu`` variables (nested dicts of arrays) -> this zoo's state dict."""
    sd: StateDict = {}
    for key, a in _flatten(params).items():
        path, leaf = key.rsplit(".", 1)
        if leaf == "kernel":
            sd[f"{path}.weight"] = torch.from_numpy(np.ascontiguousarray(_kernel_to_torch(a)))
        elif leaf in ("scale", "bias"):
            name = "weight" if leaf == "scale" else "bias"
            sd[f"{path}.{name}"] = torch.from_numpy(np.array(a))
        else:
            raise KeyError(f"unexpected parameter leaf {key}")
    for key, a in _flatten(batch_stats).items():
        path, leaf = key.rsplit(".", 1)
        sd[f"{path}.{_STAT_NAMES[leaf]}"] = torch.from_numpy(np.array(a))
        sd[f"{path}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def to_jax(state: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """This zoo's state dict -> ``ccst_tpu``'s (params, batch_stats) numpy trees."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    inverse = {v: k for k, v in _STAT_NAMES.items()}
    for key, t in state.items():
        path, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        a = t.detach().cpu().numpy()
        if leaf in inverse:
            tree, name = stats, inverse[leaf]
        elif leaf == "weight":
            tree, name = params, ("kernel" if a.ndim >= 2 else "scale")
            if a.ndim == 4:
                a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
        else:
            tree, name = params, leaf
        node = tree
        for part in path.split("."):
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(a)
    return params, stats


def convert_torchvision_resnet(state_dict: Mapping[str, Any], init_state: Mapping[str, torch.Tensor]
                               ) -> StateDict:
    """Overlay torchvision backbone weights on ``init_state`` (a new dict is
    returned; the inputs are untouched). ``fc.*`` is skipped."""
    out = {k: v.clone() for k, v in init_state.items()}
    n_convs: Dict[str, int] = {}
    for key in state_dict:
        parts = key.split(".")
        if parts[0].startswith("layer") and parts[2].startswith("conv"):
            block = f"{parts[0]}_{parts[1]}"
            n_convs[block] = max(n_convs.get(block, 0), int(parts[2][4:]))
    for key, val in state_dict.items():
        parts = key.split(".")
        if parts[0] == "fc":
            continue
        if parts[0] in ("conv1", "bn1"):
            dst = key
        elif parts[0].startswith("layer"):
            block, rest = f"{parts[0]}_{parts[1]}", parts[2:]
            if rest[0].startswith("conv"):
                dst = f"{block}.Conv_{int(rest[0][4:]) - 1}.{rest[1]}"
            elif rest[0].startswith("bn"):
                dst = f"{block}.{rest[0]}.{rest[1]}"
            elif rest[0] == "downsample":
                dst = (f"{block}.Conv_{n_convs[block]}.{rest[2]}" if rest[1] == "0"
                       else f"{block}.bn_down.{rest[2]}")
            else:
                continue
        else:
            continue
        if dst not in out:
            raise KeyError(f"{key} -> {dst}: no such entry in the model")
        src = torch.as_tensor(val).detach().cpu()
        if src.shape != out[dst].shape:
            raise ValueError(f"{key}: shape {tuple(src.shape)} against {tuple(out[dst].shape)}")
        out[dst] = src.to(out[dst].dtype).clone()
    return out


def load_imagenet_resnet(path: str, init_state: Mapping[str, torch.Tensor]
                         ) -> Tuple[StateDict, bool]:
    """torchvision weights from ``path`` if it exists: (state, loaded?). No
    download (reference nets/resnet.py:339-345 minus the download)."""
    if not path or not os.path.exists(path):
        return dict(init_state), False
    state = torch.load(path, map_location="cpu", weights_only=True)
    return convert_torchvision_resnet(state, init_state), True
