"""Weight conversion into the port's parameters.

Port of ``ccst_tpu/models/convert.py``:

  - reference ``.pth`` state dicts (``vgg_normalised.pth`` / ``decoder.pth``,
    OIHW, sequential indices) mapped onto the arch's conv order;
  - the native ``.npz`` format (``{name}/w`` HWIO, ``{name}/b``), the same bytes
    ``ccst_tpu`` writes, so one weight file feeds both packages.

A ``ccst_tpu`` parameter tree as numpy HWIO arrays needs no conversion:
:func:`ccst_tpu_torch.models.vgg.prepare_params` takes it as it is.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ccst_tpu_torch.models.vgg import DECODER_ARCH, ENCODER_ARCH, Conv, Params


def from_torch_sequential(state_dict: Mapping, arch: Sequence) -> Params:
    """A torch ``nn.Sequential`` state dict (keys like ``"2.weight"``) whose
    conv order matches the arch's Conv layers; extra trailing convs are
    ignored, as the encoder stops at relu4_1."""
    weights = {}
    for key, val in state_dict.items():
        idx_s, kind = key.rsplit(".", 1)
        weights.setdefault(int(idx_s), {})[kind] = torch.as_tensor(val).float()
    entries = [weights[i] for i in sorted(weights)]
    names = [l.name for l in arch if isinstance(l, Conv)]
    if len(entries) < len(names):
        raise ValueError(f"state dict has {len(entries)} convs; arch needs {len(names)}")
    return {
        name: {"w": e["weight"].permute(2, 3, 1, 0).contiguous(), "b": e["bias"]}
        for name, e in zip(names, entries)
    }


def load_torch_pth(path: str, arch: Sequence) -> Params:
    state = torch.load(path, map_location="cpu", weights_only=True)
    return from_torch_sequential(state, arch)


def save_npz(path: str, params: Params) -> None:
    flat = {}
    for name, entry in params.items():
        flat[f"{name}/w"] = np.asarray(torch.as_tensor(entry["w"]).float().cpu())
        flat[f"{name}/b"] = np.asarray(torch.as_tensor(entry["b"]).float().cpu())
    np.savez(path, **flat)


def load_npz(path: str) -> Params:
    params: Params = {}
    with np.load(path) as data:
        for key in data.files:
            name, kind = key.rsplit("/", 1)
            params.setdefault(name, {})[kind] = torch.as_tensor(data[key], dtype=torch.float32)
    return params


def load_weights(path: str, arch: Sequence) -> Params:
    """Dispatch on extension: ``.pth`` / ``.pt`` (torch) or ``.npz`` (native)."""
    if path.endswith(".npz"):
        return load_npz(path)
    if path.endswith((".pth", ".pt")):
        return load_torch_pth(path, arch)
    raise ValueError(f"unknown weight format: {path}")


def load_encoder(path: str) -> Params:
    return load_weights(path, ENCODER_ARCH)


def load_decoder(path: str) -> Params:
    return load_weights(path, DECODER_ARCH)
