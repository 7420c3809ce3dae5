"""Plain ResNet-50 training and evaluation of CCST's federated stage: the
network (He et al., arXiv:1512.03385; torchvision v1.5 layout, the stride on
the 3x3, a 7-way head), the train transform (RandomResizedCrop of scale 0.8-1
and aspect 3/4-4/3 resampled with an antialiased triangle filter, a
horizontal flip with p 0.5, ImageNet normalization), plain SGD on the mean
cross-entropy, FedAvg, and evaluation with the running statistics.

Functional, NCHW, in the dtype of the state it is given (float64 for the
output check). State keys follow the port's state dicts (``conv1.weight``,
``layer2_0.Conv_1.weight``, ``layer2_0.bn_down.running_var``,
``class_classifier.bias``): the harness makes one state and hands it to both.
``half_batch=True`` and ``tf32=True`` plant the faults and the control the
output check's limits are read from.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

State = Dict[str, torch.Tensor]
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
BN_EPS, BN_MOMENTUM = 1e-5, 0.1


def blocks() -> List[Tuple[str, int, int, int, bool]]:
    """(name, inplanes, planes, stride, has downsample) of every bottleneck."""
    out, inplanes = [], 64
    for stage, (planes, n, stride) in enumerate(STAGES, 1):
        for i in range(n):
            s = stride if i == 0 else 1
            out.append((f"layer{stage}_{i}", inplanes, planes, s,
                        s != 1 or inplanes != planes * 4))
            inplanes = planes * 4
    return out


def leaves(classes: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every parameter, then of every BatchNorm buffer."""
    params, bns = [("conv1.weight", (64, 3, 7, 7))], ["bn1:64"]
    for name, inplanes, planes, _, down in blocks():
        params += [(f"{name}.Conv_0.weight", (planes, inplanes, 1, 1)),
                   (f"{name}.Conv_1.weight", (planes, planes, 3, 3)),
                   (f"{name}.Conv_2.weight", (planes * 4, planes, 1, 1))]
        bns += [f"{name}.bn1:{planes}", f"{name}.bn2:{planes}", f"{name}.bn3:{planes * 4}"]
        if down:
            params.append((f"{name}.Conv_3.weight", (planes * 4, inplanes, 1, 1)))
            bns.append(f"{name}.bn_down:{planes * 4}")
    for bn in bns:
        key, c = bn.split(":")
        params += [(f"{key}.weight", (int(c),)), (f"{key}.bias", (int(c),))]
    params += [("class_classifier.weight", (classes, 2048)), ("class_classifier.bias", (classes,))]
    buffers = []
    for bn in bns:
        key, c = bn.split(":")
        buffers += [(f"{key}.running_mean", (int(c),)), (f"{key}.running_var", (int(c),))]
    return params + buffers


def make_state(generator: torch.Generator, classes: int) -> State:
    """Every float leaf, on the generator's device, from one normal draw:
    convs with Kaiming's fan-out normal (std sqrt(2 / fan out)), the head with
    LeCun's normal (std sqrt(1 / fan in)), biases and means 0, scales and
    variances 1."""
    entries = leaves(classes)
    weights = [(k, s) for k, s in entries if k.endswith("weight") and len(s) > 1]
    z = torch.randn((sum(math.prod(s) for _, s in weights),), generator=generator,
                    device=generator.device)
    state, at = {}, 0
    for key, shape in weights:
        n = math.prod(shape)
        fan = shape[0] * math.prod(shape[2:]) if len(shape) == 4 else shape[1]
        gain = 2.0 if len(shape) == 4 else 1.0
        state[key] = (z[at:at + n] * math.sqrt(gain / fan)).reshape(shape)
        at += n
    for key, shape in entries:
        if key not in state:
            fill = 1.0 if key.endswith(("weight", "running_var")) else 0.0
            state[key] = torch.full(shape, fill, device=generator.device)
    return state


def parameter_keys(state: State) -> List[str]:
    return [k for k in state if not k.endswith(("running_mean", "running_var",
                                                  "num_batches_tracked"))]


def _bn(x, state: State, key: str, train: bool, new: Optional[State]):
    mean, var = state[f"{key}.running_mean"], state[f"{key}.running_var"]
    if train:
        mean, var = mean.clone(), var.clone()
    y = F.batch_norm(x, mean, var, state[f"{key}.weight"], state[f"{key}.bias"], train,
                     BN_MOMENTUM, BN_EPS)
    if train and new is not None:
        new[f"{key}.running_mean"], new[f"{key}.running_var"] = mean, var
    return y


def forward(state: State, x: torch.Tensor, train: bool, new: Optional[State] = None):
    """Logits of NCHW images; in training the BatchNorm running statistics
    the pass leaves go into ``new``."""
    y = F.conv2d(x, state["conv1.weight"], stride=2, padding=3)
    y = F.relu(_bn(y, state, "bn1", train, new))
    y = F.max_pool2d(y, 3, 2, 1)
    for name, _, _, stride, down in blocks():
        out = F.relu(_bn(F.conv2d(y, state[f"{name}.Conv_0.weight"]), state,
                         f"{name}.bn1", train, new))
        out = F.relu(_bn(F.conv2d(out, state[f"{name}.Conv_1.weight"], stride=stride,
                                  padding=1), state, f"{name}.bn2", train, new))
        out = _bn(F.conv2d(out, state[f"{name}.Conv_2.weight"]), state, f"{name}.bn3", train, new)
        if down:
            y = _bn(F.conv2d(y, state[f"{name}.Conv_3.weight"], stride=stride), state,
                    f"{name}.bn_down", train, new)
        y = F.relu(out + y)
    y = y.mean(dim=(2, 3))
    return F.linear(y, state["class_classifier.weight"], state["class_classifier.bias"])


def normalize(x_nhwc: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, dtype=x_nhwc.dtype, device=x_nhwc.device)
    std = torch.tensor(STD, dtype=x_nhwc.dtype, device=x_nhwc.device)
    return ((x_nhwc - mean) / std).permute(0, 3, 1, 2)


def draw_crops(generator: torch.Generator, n: int, side: int, min_scale: float = 0.8,
               max_scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step's transform draws from ``generator``, in float32 on the host:
    four uniforms a row (area scale, log aspect, x offset, y offset; a box
    that does not fit is clamped, not redrawn) as boxes (y0, x0, h, w), then
    one uniform a row for the flip."""
    u = torch.rand((n, 4), generator=generator)
    area = (side * side) * (u[:, 0] * (max_scale - min_scale) + min_scale)
    lo, hi = math.log(3.0 / 4.0), math.log(4.0 / 3.0)
    aspect = torch.exp(u[:, 1] * (hi - lo) + lo)
    cw = torch.sqrt(area * aspect).clamp(1.0, side)
    ch = torch.sqrt(area / aspect).clamp(1.0, side)
    boxes = torch.stack([u[:, 3] * (side - ch), u[:, 2] * (side - cw), ch, cw], dim=1)
    return boxes, torch.rand((n,), generator=generator) < 0.5


def _triangle_weights(n_in: int, n_out: int, start: torch.Tensor, length: torch.Tensor):
    """(N, in, out): output sample j of each row covers [start, start + length)
    of the input, the triangle kernel widened by the downscale factor,
    weights normalised to sum 1, samples outside the input left at 0."""
    dt, dev = start.dtype, start.device
    inv = length / n_out
    width = torch.clamp(inv, min=1.0)
    pos = (torch.arange(n_out, dtype=dt, device=dev) + 0.5) * inv[:, None] + start[:, None] - 0.5
    dist = (pos[:, None, :] - torch.arange(n_in, dtype=dt, device=dev)[None, :, None]).abs()
    w = torch.clamp(1.0 - dist / width[:, None, None], min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total > 1000 * np.finfo(np.float32).eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return torch.where(inside[:, None, :], w, torch.zeros_like(w))


def train_transform(images: torch.Tensor, boxes: torch.Tensor, flips: torch.Tensor,
                    out: int) -> torch.Tensor:
    """(N, H, W, 3) in [0, 1] -> normalized NCHW crops of ``out`` px."""
    n, h, w, _ = images.shape
    b = boxes.to(images.device, images.dtype)
    wy = _triangle_weights(h, out, b[:, 0], b[:, 2])
    wx = _triangle_weights(w, out, b[:, 1], b[:, 3])
    crops = torch.einsum("niy,njx,nijc->nyxc", wy, wx, images)
    crops = torch.where(flips.to(images.device)[:, None, None, None], crops.flip(2), crops)
    return normalize(crops)


def sgd_step(state: State, images: torch.Tensor, labels: torch.Tensor, boxes, flips,
             lr: float, out: int, half_batch: bool = False
             ) -> Tuple[State, float, State]:
    """One local step: (new state, loss, the gradient of every parameter).
    ``half_batch`` leaves out the second half of the rows (a fault)."""
    if half_batch:
        k = images.shape[0] // 2
        images, labels, boxes, flips = images[:k], labels[:k], boxes[:k], flips[:k]
    keys = parameter_keys(state)
    params = {k: state[k].detach().clone().requires_grad_(True) for k in keys}
    new: State = {}
    with torch.enable_grad():
        logits = forward({**state, **params}, train_transform(images, boxes, flips, out), True, new)
        loss = F.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, [params[k] for k in keys])
    grad = {k: g.detach() for k, g in zip(keys, grads)}
    stepped = {k: (state[k] - lr * grad[k]) if k in grad else new.get(k, state[k]) for k in state}
    return stepped, float(loss.detach()), grad


def fedavg(states: Sequence[State], dtype=torch.float64) -> State:
    """The mean of the clients' float leaves, with equal weights."""
    return {k: sum(s[k].to(dtype) for s in states) / len(states)
            for k in states[0] if states[0][k].is_floating_point()}


@torch.no_grad()
def evaluate(state: State, images_u8: torch.Tensor, labels: torch.Tensor, block: int,
             dtype=torch.float64) -> Tuple[float, float]:
    """(mean cross-entropy, accuracy) of the rows in eval mode (running
    statistics), ``block`` rows at a time."""
    s = {k: v.to(dtype) for k, v in state.items() if v.is_floating_point()}
    loss, hits = 0.0, 0
    for i in range(0, images_u8.shape[0], block):
        x = normalize(images_u8[i:i + block].to(s["conv1.weight"].device, dtype) / 255.0)
        logits = forward(s, x, False)
        y = labels[i:i + block].to(logits.device)
        loss += float(F.cross_entropy(logits, y, reduction="sum"))
        hits += int((logits.argmax(1) == y).sum())
    n = max(images_u8.shape[0], 1)
    return loss / n, hits / n
