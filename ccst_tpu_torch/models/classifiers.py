"""Classifier zoo (PyTorch, NCHW): ResNet-18/50 (+IN / Jigsaw / MixStyle),
DenseNet-121 (Camelyon17's stat-free norm), DigitModel, AlexNet.

Counterpart of ``ccst_tpu/models/classifiers.py``. Module names follow the JAX
tree, so one state-dict key names the same leaf in both packages
(``conv1``, ``bn1``, ``layer{stage}_{i}`` with ``Conv_k`` / ``bn1..bn3`` /
``bn_down`` inside, ``class_classifier``): FedBN's rule "a path component
starts with ``bn``" (``federated/aggregate.py``) then keeps the same leaves
local in both, and ``convert_resnet.from_jax`` is a transpose per leaf. The
flattening heads of ``DigitModel`` and ``AlexNet`` flatten in channels-last
order, as the JAX models do, for the same reason.

Initial values follow the JAX package's distributions, drawn from an explicit
``torch.Generator`` by :func:`init_weights` (torch's default inits are never
used): truncated ``kaiming_normal`` (fan out) for the ResNet / DenseNet convs,
flax's ``lecun_normal`` with zero bias for every ``Linear`` and for the convs
of ``DigitModel`` / ``AlexNet``.

Known reference divergences, as in the JAX package: DenseNet honours the class
count; global average pooling replaces ``AvgPool2d(7)`` (the same at 222 px).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ccst_tpu_torch.models.layers import (
    MixDraws,
    MixStyle,
    StatFreeNorm,
    avg_pool,
    global_avg_pool,
    kaiming_normal_fan_out_,
    lecun_normal_,
    make_norm,
    max_pool_same,
)

JIGSAW_CLASSES = 31  # 30 permutations + "unshuffled" (nets/resnet.py:266)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, norm: str = "bn"):
        super().__init__()
        self.Conv_0 = _conv(inplanes, planes, 3, stride, 1)
        self.bn1 = make_norm(norm, planes)
        self.Conv_1 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = make_norm(norm, planes)
        self.down = stride != 1 or inplanes != planes
        if self.down:
            self.Conv_2 = _conv(inplanes, planes, 1, stride)
            self.bn_down = make_norm(norm, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.Conv_0(x)))
        out = self.bn2(self.Conv_1(out))
        identity = self.bn_down(self.Conv_2(x)) if self.down else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """torchvision v1.5: the stride on the 3x3."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, norm: str = "bn"):
        super().__init__()
        self.Conv_0 = _conv(inplanes, planes, 1)
        self.bn1 = make_norm(norm, planes)
        self.Conv_1 = _conv(planes, planes, 3, stride, 1)
        self.bn2 = make_norm(norm, planes)
        self.Conv_2 = _conv(planes, planes * 4, 1)
        self.bn3 = make_norm(norm, planes * 4)
        self.down = stride != 1 or inplanes != planes * 4
        if self.down:
            self.Conv_3 = _conv(inplanes, planes * 4, 1, stride)
            self.bn_down = make_norm(norm, planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.Conv_0(x)))
        out = F.relu(self.bn2(self.Conv_1(out)))
        out = self.bn3(self.Conv_2(out))
        identity = self.bn_down(self.Conv_3(x)) if self.down else x
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet with the reference's renamed head (nets/resnet.py:132-191).

    ``jigsaw=True`` adds the 31-way head and returns (class_logits,
    jig_logits); ``mixstyle_layers`` inserts MixStyle after the named stages,
    which apply the ``mix_draws`` given to ``forward`` in order, one a stage
    (none: identity); ``n_mix`` is their number.
    """

    def __init__(self, classes: int, block: str = "basic",
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), norm: str = "bn",
                 jigsaw: bool = False, mixstyle_layers: Sequence[str] = (),
                 mixstyle_p: float = 0.5, mixstyle_alpha: float = 0.1):
        super().__init__()
        self.config = dict(classes=classes, block=block, stage_sizes=tuple(stage_sizes),
                           norm=norm, jigsaw=jigsaw, mixstyle_layers=tuple(mixstyle_layers),
                           mixstyle_p=mixstyle_p, mixstyle_alpha=mixstyle_alpha)
        self.norm = norm
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = make_norm(norm, 64)
        self.mix = MixStyle(mixstyle_p, mixstyle_alpha) if mixstyle_layers else None
        self.mixstyle_layers = tuple(mixstyle_layers)
        self.n_mix = sum(f"layer{i}" in self.mixstyle_layers for i in range(1, 5))
        self.stages = []
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), stage_sizes), 1):
            names = []
            for i in range(n_blocks):
                stride = 2 if (stage > 1 and i == 0) else 1
                setattr(self, f"layer{stage}_{i}", block_cls(inplanes, planes, stride, norm))
                names.append(f"layer{stage}_{i}")
                inplanes = planes * block_cls.expansion
            self.stages.append(names)
        self.class_classifier = nn.Linear(inplanes, classes)
        self.jigsaw = jigsaw
        if jigsaw:
            self.jig_classifier = nn.Linear(inplanes, JIGSAW_CLASSES)

    def with_norm(self, norm: str) -> "ResNet":
        """The same network with another norm kind (``--in-test``: IN that
        reuses the BN affine leaves under the same names)."""
        return ResNet(**{**self.config, "norm": norm})

    def forward(self, x: torch.Tensor, return_features: bool = False,
                mix_draws: Optional[Sequence[MixDraws]] = None):
        draws = iter(mix_draws or ())
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_same(x, 3, 2, 1)
        for stage, names in enumerate(self.stages, 1):
            for name in names:
                x = getattr(self, name)(x)
            if self.mix is not None and f"layer{stage}" in self.mixstyle_layers:
                x = self.mix(x, next(draws, None))
        x = global_avg_pool(x)
        if return_features:
            return x  # pooled penultimate vector (RSC's featurizer output)
        logits = self.class_classifier(x)
        if self.jigsaw:
            return logits, self.jig_classifier(x)
        return logits


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4, drop_rate: float = 0.0):
        super().__init__()
        self.norm0, self.norm1 = StatFreeNorm(), StatFreeNorm()
        self.Conv_0 = _conv(cin, bn_size * growth_rate, 1)
        self.Conv_1 = _conv(bn_size * growth_rate, growth_rate, 3, 1, 1)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.Conv_0(F.relu(self.norm0(x)))
        out = self.Conv_1(F.relu(self.norm1(out)))
        if self.drop_rate > 0:
            out = F.dropout(out, self.drop_rate, self.training)
        return torch.cat([x, out], dim=1)


class DenseNet(nn.Module):
    """DenseNet-BC with stat-free normalization (nets/densenet.py:47-153),
    including the reference's ``zero_padding`` after dense block 1 (:86)."""

    def __init__(self, classes: int = 2, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16), num_init_features: int = 64,
                 bn_size: int = 4, drop_rate: float = 0.0, jigsaw: bool = False,
                 mixstyle: bool = False):
        super().__init__()
        self.conv0 = nn.Conv2d(3, num_init_features, 7, 2, 3, bias=False)
        self.norm0 = StatFreeNorm()
        self.block_config = tuple(block_config)
        self.mix = MixStyle(0.5, 0.1) if mixstyle else None
        self.n_mix = min(2, len(self.block_config)) if mixstyle else 0
        nf = num_init_features
        for i, n_layers in enumerate(self.block_config):
            for j in range(n_layers):
                setattr(self, f"denseblock{i + 1}_layer{j + 1}",
                        DenseLayer(nf + j * growth_rate, growth_rate, bn_size, drop_rate))
            nf += n_layers * growth_rate
            if i != len(self.block_config) - 1:
                setattr(self, f"transition{i + 1}", _conv(nf, nf // 2, 1))
                nf //= 2
        self.transition_norm, self.norm_final = StatFreeNorm(), StatFreeNorm()
        self.classifier = nn.Linear(nf, classes)
        self.jigsaw = jigsaw
        if jigsaw:
            self.jig_classifier = nn.Linear(nf, JIGSAW_CLASSES)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                mix_draws: Optional[Sequence[MixDraws]] = None):
        draws = iter(mix_draws or ())
        x = max_pool_same(F.relu(self.norm0(self.conv0(x))), 3, 2, 1)
        for i, n_layers in enumerate(self.block_config):
            for j in range(n_layers):
                x = getattr(self, f"denseblock{i + 1}_layer{j + 1}")(x)
            if self.mix is not None and i in (0, 1):
                x = self.mix(x, next(draws, None))
            if i == 0:
                x = F.pad(x, (2, 2, 2, 2))  # zero_padding
            if i != len(self.block_config) - 1:
                x = getattr(self, f"transition{i + 1}")(F.relu(self.transition_norm(x)))
                x = avg_pool(x, 2, 2)
        x = global_avg_pool(F.relu(self.norm_final(x)))
        if return_features:
            return x
        logits = self.classifier(x)
        if self.jigsaw:
            return logits, self.jig_classifier(x)
        return logits


def _flatten_channels_last(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W*C) in the JAX models' NHWC order."""
    return x.permute(0, 2, 3, 1).flatten(1)


class DigitModel(nn.Module):
    """3-conv / 3-fc digits model (nets/models.py:65-105), 28 px."""

    def __init__(self, classes: int = 10, image_size: int = 28):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 5, 1, 2)
        self.bn1 = nn.BatchNorm2d(64)
        self.Conv_1 = nn.Conv2d(64, 64, 5, 1, 2)
        self.bn2 = nn.BatchNorm2d(64)
        self.Conv_2 = nn.Conv2d(64, 128, 5, 1, 2)
        self.bn3 = nn.BatchNorm2d(128)
        side = image_size // 2 // 2
        self.Dense_0 = nn.Linear(128 * side * side, 2048)
        self.bn4 = nn.BatchNorm1d(2048)
        self.Dense_1 = nn.Linear(2048, 512)
        self.bn5 = nn.BatchNorm1d(512)
        self.class_classifier = nn.Linear(512, classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                mix_draws: Optional[Sequence[MixDraws]] = None):
        x = max_pool_same(F.relu(self.bn1(self.Conv_0(x))), 2, 2, 0)
        x = max_pool_same(F.relu(self.bn2(self.Conv_1(x))), 2, 2, 0)
        x = _flatten_channels_last(F.relu(self.bn3(self.Conv_2(x))))
        x = F.relu(self.bn4(self.Dense_0(x)))
        x = F.relu(self.bn5(self.Dense_1(x)))
        return x if return_features else self.class_classifier(x)


class AlexNet(nn.Module):
    """BN AlexNet (nets/models.py:7-62), explicit bn1..bn7 names."""

    def __init__(self, classes: int = 10):
        super().__init__()
        specs = ((3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
                 (384, 256, 3, 1, 1), (256, 256, 3, 1, 1))
        for i, (cin, cout, k, s, p) in enumerate(specs):
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, cout, k, s, p))
            setattr(self, f"bn{i + 1}", nn.BatchNorm2d(cout))
        self.Dense_0 = nn.Linear(256 * 6 * 6, 4096)
        self.bn6 = nn.BatchNorm1d(4096)
        self.Dense_1 = nn.Linear(4096, 4096)
        self.bn7 = nn.BatchNorm1d(4096)
        self.class_classifier = nn.Linear(4096, classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                mix_draws: Optional[Sequence[MixDraws]] = None):
        for i in range(5):
            x = F.relu(getattr(self, f"bn{i + 1}")(getattr(self, f"Conv_{i}")(x)))
            if i in (0, 1, 4):
                x = max_pool_same(x, 3, 2, 0)
        if x.shape[2] != 6 or x.shape[3] != 6:
            # jax.image.resize(..., "bilinear"), antialiased like the JAX model
            x = F.interpolate(x, size=(6, 6), mode="bilinear", align_corners=False,
                              antialias=True)
        x = F.relu(self.bn6(self.Dense_0(_flatten_channels_last(x))))
        x = F.relu(self.bn7(self.Dense_1(x)))
        return x if return_features else self.class_classifier(x)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight as the JAX zoo's initializers do, in module order,
    from ``generator``; biases and norm shifts zero, norm scales one, running
    statistics (0, 1)."""
    conv_init = (kaiming_normal_fan_out_ if isinstance(model, (ResNet, DenseNet))
                 else lecun_normal_)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            conv_init(m.weight, generator)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, generator)
        else:
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)
    return model


# ---------------------------------------------------------------------------
# Registry (nets/models.py:114-133)
# ---------------------------------------------------------------------------


def get_network(name: str, classes: int, dg_method: str = "no_DG") -> nn.Module:
    """Build a classifier by registry name with the DG-method variants the
    reference selects (nets/resnet.py:314-369, nets/densenet.py:141-153).
    Weights are torch's defaults until :func:`init_weights` draws them."""
    dg = dg_method.lower()
    jigsaw = dg == "jigsaw"
    mixstyle = dg == "mixstyle"
    mix_layers = ("layer1", "layer2", "layer3") if mixstyle else ()

    if name == "resnet4":
        return ResNet(classes, "basic", (1, 1, 1, 1), jigsaw=jigsaw, mixstyle_layers=mix_layers)
    if name == "resnet18":
        return ResNet(classes, "basic", (2, 2, 2, 2), jigsaw=jigsaw, mixstyle_layers=mix_layers)
    if name == "resnet18IN":
        return ResNet(classes, "basic", (2, 2, 2, 2), norm="in")
    if name == "resnet50":
        return ResNet(classes, "bottleneck", (3, 4, 6, 3), jigsaw=jigsaw,
                      mixstyle_layers=mix_layers)
    if name == "DigitModel":
        return DigitModel(classes)
    if name == "densenet":
        return DenseNet(classes, jigsaw=jigsaw, mixstyle=mixstyle)
    if name == "alexnet":
        return AlexNet(classes)
    raise ValueError(f"Name of network unknown {name}")


NETS = ("resnet4", "resnet18", "resnet18IN", "resnet50", "DigitModel", "densenet", "alexnet")
