"""Counts of ResNet-50 (He et al., arXiv:1512.03385; torchvision v1.5 widths,
the stride on the 3x3) from shapes.

A model FLOP is 2 x one multiply-accumulate of a conv or of the linear head;
BatchNorm, ReLU, the pools and the loss are left out. A training image costs
the forward pass, the gradient of every conv's input except the first (the
images need none) and the gradient of every weight; an evaluated image costs
the forward pass. At 222 px one forward pass is 8.1 GFLOP.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))  # planes, blocks, stride


class RConv(NamedTuple):
    name: str
    cin: int
    cout: int
    k: int
    side_in: int
    side_out: int

    def macs(self) -> int:
        return self.side_out * self.side_out * self.k * self.k * self.cin * self.cout


def _out(side: int, k: int, stride: int, pad: int) -> int:
    return (side + 2 * pad - k) // stride + 1


def convs(size: int) -> List[RConv]:
    """Every conv of one forward pass, in order."""
    side = _out(size, 7, 2, 3)
    out = [RConv("conv1", 3, 64, 7, size, side)]
    side = _out(side, 3, 2, 1)  # max pool
    inplanes = 64
    for stage, (planes, blocks, stride) in enumerate(STAGES, 1):
        for i in range(blocks):
            s = stride if i == 0 else 1
            mid = _out(side, 3, s, 1)
            name = f"layer{stage}_{i}"
            out.append(RConv(f"{name}.Conv_0", inplanes, planes, 1, side, side))
            out.append(RConv(f"{name}.Conv_1", planes, planes, 3, side, mid))
            out.append(RConv(f"{name}.Conv_2", planes, planes * 4, 1, mid, mid))
            if s != 1 or inplanes != planes * 4:
                out.append(RConv(f"{name}.Conv_3", inplanes, planes * 4, 1, side, mid))
            inplanes, side = planes * 4, mid
    return out


def head_macs(classes: int) -> int:
    return 2048 * classes


def forward_flops(size: int, classes: int) -> float:
    """Model FLOPs of one image's forward pass."""
    return 2.0 * (sum(c.macs() for c in convs(size)) + head_macs(classes))


def train_flops(size: int, classes: int) -> float:
    """Model FLOPs of one training image: forward, input gradients (not the
    first conv's) and weight gradients."""
    cs = convs(size)
    fwd = sum(c.macs() for c in cs)
    dgrad = fwd - cs[0].macs()
    return 2.0 * (fwd + dgrad + fwd + 3 * head_macs(classes))


def conv_work(size: int, batch: int, train: bool) -> List[Tuple[float, float]]:
    """(operations, bytes) of every conv computation of one step at ``batch``
    rows in float32: the forward pass, and for a training step each conv's
    input gradient (not the first's) and weight gradient. Each computation
    reads its two operands once and writes its result once."""
    work = []
    for i, c in enumerate(convs(size)):
        x = 4.0 * batch * c.side_in * c.side_in * c.cin
        y = 4.0 * batch * c.side_out * c.side_out * c.cout
        w = 4.0 * c.k * c.k * c.cin * c.cout
        ops = 2.0 * batch * c.macs()
        work.append((ops, x + w + y))          # forward
        if train:
            if i:
                work.append((ops, y + w + x))  # input gradient
            work.append((ops, x + y + w))      # weight gradient
    return work
