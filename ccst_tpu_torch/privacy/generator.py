"""Style-vector -> image generator for the privacy analysis.

Port of ``ccst_tpu/privacy/generator.py``: the lightweight-GAN family
(reconstruct_img/lightweight_gan/lightweight_gan.py:515-628) that inverts a
1024-d style vector (relu4_1 mean ‖ std) back to the image, with progressive
nearest-2x upsampling through GLU-gated convs, skip-layer excitation (SLE)
and optional linear + 3x3-window attention.

The modules take and return NHWC tensors and compute in NCHW inside. Their
children carry flax's own names (``Dense_0``, ``GLUConv_2``, ``attn_32``,
``SLE_0``, ``Conv_0``, ...), so that :func:`from_flax` maps a ``ccst_tpu``
parameter tree onto the state dict name for name (Dense ``(in, out)`` ->
``(out, in)``, Conv HWIO -> OIHW) and :func:`to_flax` maps it back. Layers
match flax's: ``nn.Conv(padding=1)`` pads with zeros, the default ``"SAME"``
pads as XLA does, kernels start as ``lecun_normal`` and biases at zero.
Power-of-two output sizes.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Padding = Union[str, int]


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW: ``padding`` an int (zeros, each side),
    ``"SAME"`` (XLA's split, the extra row below) or ``"VALID"``."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1,
                 padding: Padding = "SAME", bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.ksize = stride, padding, ksize
        self.weight = nn.Parameter(torch.empty(cout, cin, ksize, ksize))
        _lecun_normal_(self.weight, cin * ksize * ksize, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def _pads(self, size: int) -> Tuple[int, int]:
        if isinstance(self.padding, int):
            return self.padding, self.padding
        if self.padding == "VALID":
            return 0, 0
        out = -(-size // self.stride)
        total = max((out - 1) * self.stride + self.ksize - size, 0)
        return total // 2, total - total // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = self._pads(x.shape[2]), self._pads(x.shape[3])
        if t or b or l or r:
            x = F.pad(x, (l, r, t, b))
        return F.conv2d(x, self.weight, self.bias, self.stride)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``lecun_normal`` kernel, zero bias."""

    def __init__(self, cin: int, cout: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        _lecun_normal_(self.weight, cin, generator)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x on NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class GLUConv(nn.Module):
    """conv -> norm-free GLU gate (lightweight-GAN's upsample block core)."""

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__()
        self.features = features
        self.Conv_0 = Conv(cin, features * 2, 3, padding=1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(x)
        return y[:, :self.features] * torch.sigmoid(y[:, self.features:])


class SLE(nn.Module):
    """Skip-layer excitation: ``low`` averaged to 4x4, a 4x4 VALID conv to
    1x1, SiLU, a 1x1 conv, sigmoid, gating the high-res path's channels."""

    def __init__(self, cin: int, features: int, generator=None):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 4, padding="VALID", generator=generator)
        self.Conv_1 = Conv(features, features, 1, generator=generator)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        if low.shape[2] < 4 or low.shape[2] % 4:
            raise ValueError(f"SLE expects a low-res input divisible by 4, got {tuple(low.shape)}")
        k = low.shape[2] // 4
        s = F.avg_pool2d(low, k) if k > 1 else low
        s = self.Conv_1(F.silu(self.Conv_0(s)))
        return high * torch.sigmoid(s)


class LinearAttention(nn.Module):
    """Global linear attention beside 3x3-window attention, concatenated and
    projected (the residual is the caller's): ``Conv_0..2`` the linear path's
    q, k, v, ``Conv_3`` / ``Conv_4`` the window path's q and k ‖ v,
    ``Conv_5`` the projection."""

    def __init__(self, c: int, dim_head: int = 64, heads: int = 4, generator=None):
        super().__init__()
        self.dim_head, self.heads = dim_head, heads
        inner = dim_head * heads
        for i in range(4):
            setattr(self, f"Conv_{i}", Conv(c, inner, 1, bias=False, generator=generator))
        self.Conv_4 = Conv(c, inner * 2, 1, bias=False, generator=generator)
        self.Conv_5 = Conv(inner * 2, c, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        inner, dh = self.dim_head * self.heads, self.dim_head
        scale = dh ** -0.5

        def split_heads(t):  # NCHW (n, inner, h, w) -> (n, heads, hw, dh)
            return t.permute(0, 2, 3, 1).reshape(n, h * w, self.heads, dh).transpose(1, 2)

        lq = torch.softmax(split_heads(self.Conv_0(x)), dim=-1) * scale
        lk = torch.softmax(split_heads(self.Conv_1(x)), dim=-2)
        lv = split_heads(self.Conv_2(x))
        ctx = torch.einsum("nhpd,nhpe->nhde", lk, lv)
        lin = torch.einsum("nhpd,nhde->nhpe", lq, ctx)
        lin = F.gelu(lin.transpose(1, 2).reshape(n, h, w, inner), approximate="tanh")

        q = split_heads(self.Conv_3(x)) * scale
        # (n, 2 inner * 9, hw), channel-major then window, as
        # conv_general_dilated_patches orders its features
        patches = F.unfold(self.Conv_4(x), 3, padding=1).transpose(1, 2)
        patches = patches.reshape(n, h * w, 2, self.heads, dh, 9).permute(2, 0, 3, 1, 5, 4)
        k9, v9 = patches[0], patches[1]
        sim = torch.einsum("nhpd,nhpjd->nhpj", q, k9)
        sim = sim - sim.amax(dim=-1, keepdim=True).detach()
        attn = torch.softmax(sim, dim=-1)
        loc = torch.einsum("nhpj,nhpjd->nhpd", attn, v9)
        loc = loc.transpose(1, 2).reshape(n, h, w, inner)
        return self.Conv_5(torch.cat([lin, loc], dim=-1).permute(0, 3, 1, 2))


class StyleInverter(nn.Module):
    """latent (B, latent_dim) -> image (B, S, S, 3) in [0, 1]."""

    def __init__(self, image_size: int = 256, latent_dim: int = 1024, fmap_max: int = 256,
                 attn_res: Sequence[int] = (), generator: Optional[torch.Generator] = None):
        super().__init__()
        self.image_size, self.latent_dim = image_size, latent_dim
        self.attn_res = tuple(attn_res)
        if image_size & (image_size - 1) or image_size < 4:
            raise ValueError(f"image_size must be a power of 2, got {image_size}")
        # the channel schedule: wide at 4x4, narrowing upward
        chans = [min(fmap_max, 2 ** (10 - i)) for i in range(int(math.log2(image_size)) - 1)]
        self.chans = chans
        self.Dense_0 = Dense(latent_dim, 16 * chans[0], generator)
        feats, res, n_sle = {4: chans[0]}, 4, 0
        self._plan = []  # per upsample step: (res, attention?, SLE index or None)
        for i in range(len(chans) - 1):
            setattr(self, f"GLUConv_{i}", GLUConv(chans[i], chans[i + 1], generator))
            res *= 2
            if res in self.attn_res:
                setattr(self, f"attn_{res}", LinearAttention(chans[i + 1], generator=generator))
            feats[res] = chans[i + 1]
            sle = None
            if res // 16 in feats and res >= 64:
                setattr(self, f"SLE_{n_sle}", SLE(feats[res // 16], chans[i + 1], generator))
                sle, n_sle = n_sle, n_sle + 1
            self._plan.append((res, res in self.attn_res, sle))
        self.Conv_0 = Conv(chans[-1], 3, 3, padding=1, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(z).reshape(z.shape[0], 4, 4, self.chans[0]).permute(0, 3, 1, 2)
        x = F.silu(x)
        feats = {4: x}
        for i, (res, attn, sle) in enumerate(self._plan):
            x = getattr(self, f"GLUConv_{i}")(_upsample2x(x))
            if attn:
                x = x + getattr(self, f"attn_{res}")(x)
            if sle is not None:
                x = getattr(self, f"SLE_{sle}")(feats[res // 16], x)
            feats[res] = x
        return torch.sigmoid(self.Conv_0(x)).permute(0, 2, 3, 1)


def from_flax(tree) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (numpy or JAX arrays; ``ccst_tpu``'s params of
    these modules) -> a state dict of this module's names: ``kernel`` becomes
    ``weight`` (Dense transposed, Conv HWIO -> OIHW), ``bias`` stays."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
                continue
            a = torch.from_numpy(np.array(v, dtype=np.float32))
            if k == "kernel":
                a = a.permute(3, 2, 0, 1) if a.ndim == 4 else a.T
                k = "weight"
            out[prefix + k] = a.contiguous()

    walk(tree, "")
    return out


def to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`from_flax`: a nested dict of float32 numpy arrays."""
    tree: dict = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        a = t.detach().float().cpu()
        if leaf == "weight":
            a = a.permute(2, 3, 1, 0) if a.ndim == 4 else a.T
            leaf = "kernel"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a.numpy())
    return tree
