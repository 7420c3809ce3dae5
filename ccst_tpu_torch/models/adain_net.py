"""AdaIN training objective (decoder training).

Port of ``ccst_tpu/models/adain_net.py`` (reference ``Net``,
style_transfer/AdaIN/net.py:95-152): frozen encoder, content loss =
MSE(relu4_1(g_t), t), style loss = sum over the relu{1..4}_1 taps of the MSE of
the per-channel (mean, std), ``ddof=1``.

The encoder is frozen and takes two routes (``models/vgg.py``): the passes
that need no gradient (the style image's four taps, the content image's
relu4_1) run on the kernel route, K3 on the card, under ``torch.no_grad()``,
where JAX's ``stop_gradient``s stand; the decoder's output goes through the
autograd route, whose weights require no grad, so that the gradient reaches
the decoder through it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ccst_tpu_torch.models import vgg
from ccst_tpu_torch.ops.adain import adain, calc_mean_std


class FrozenEncoder(NamedTuple):
    """The encoder's two forms. ``kernel`` is None for a float64 reference,
    whose grad-free passes then take the autograd route too (the kernel
    route's plain version sums in float32)."""

    kernel: Optional[vgg.Prepared]
    autograd: vgg.Trainable


def frozen_encoder(params, device, dtype: torch.dtype = torch.float32,
                   kernel: bool = True) -> FrozenEncoder:
    return FrozenEncoder(
        kernel=vgg.prepare_params(params, dtype, device) if kernel else None,
        autograd=vgg.trainable_params(params, device, dtype, requires_grad=False))


def _frozen_taps(encoder: FrozenEncoder, images: torch.Tensor):
    with torch.no_grad():
        if encoder.kernel is not None:
            return vgg.encoder_taps(encoder.kernel, images)
        return vgg.encoder_taps(encoder.autograd, images, route="autograd")


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a - b))


def adain_losses(encoder: FrozenEncoder, decoder: vgg.Trainable, content: torch.Tensor,
                 style: torch.Tensor, alpha: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(content_loss, style_loss) of one batch (net.py:138-152); the decoder's
    parameters carry the gradient."""
    style_feats = _frozen_taps(encoder, style)
    content_feat = _frozen_taps(encoder, content)["relu4_1"]
    with torch.no_grad():  # encoder frozen; t is the regression target
        t = adain(content_feat, style_feats["relu4_1"])
        t = alpha * t + (1 - alpha) * content_feat

    g_t = vgg.apply_decoder(decoder, t, route="autograd")
    g_t_feats = vgg.encoder_taps(encoder.autograd, g_t, route="autograd")

    loss_c = _mse(g_t_feats["relu4_1"], t)
    loss_s = torch.zeros((), dtype=loss_c.dtype, device=loss_c.device)
    for name in vgg.TAPS:
        gm, gs = calc_mean_std(g_t_feats[name])
        sm, ss = calc_mean_std(style_feats[name])
        loss_s = loss_s + _mse(gm, sm) + _mse(gs, ss)
    return loss_c, loss_s


def decoder_leaves(decoder: vgg.Trainable):
    """The decoder's parameters in a fixed order: layer by layer, w then b."""
    return [decoder[name][k] for name in decoder for k in ("w", "b")]


def adain_train_step(encoder: FrozenEncoder, decoder: vgg.Trainable, content: torch.Tensor,
                     style: torch.Tensor, lr: float = 1e-4, style_weight: float = 10.0,
                     content_weight: float = 1.0, group=None) -> torch.Tensor:
    """One SGD step on the decoder, in place; returns the loss. With
    ``group`` (a ``torch.distributed`` process group, JAX's ``axis_name``)
    the gradients and the loss are averaged over its ranks."""
    lc, ls = adain_losses(encoder, decoder, content, style)
    loss = content_weight * lc + style_weight * ls
    leaves = decoder_leaves(decoder)
    grads = list(torch.autograd.grad(loss, leaves))
    if group is not None:
        from ccst_tpu_torch.parallel.multihost import all_reduce_mean

        *grads, loss = all_reduce_mean(grads + [loss.detach()], group)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.sub_(lr * g)
    return loss.detach()
