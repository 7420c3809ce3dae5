"""Spatial (H-axis) sharding of the stylize path over ranks.

Counterpart of ``ccst_tpu/parallel/spatial.py``. There the image height is
sharded over a ``spatial`` mesh axis and XLA's SPMD partitioner inserts the
halo exchanges; here the "spatial" ranks form a ``torch.distributed`` process
group (:func:`make_spatial_mesh`), each rank holds a block of rows of every
image (:func:`own_rows`, the counterpart of ``device_put`` with ``P(None,
"spatial")``), and the exchanges are explicit:

  - Before every 3x3 conv a rank sends its first row to the rank above and
    its last row to the rank below and receives theirs
    (:func:`exchange_halo`). The conv kernel (K3 on the ``ref`` route, K0 on
    the int8-static route) runs on [halo above] + block + [halo below] with
    its own padding, and the output rows of the halos are dropped
    (:func:`halo_conv`). At the image's own top and bottom there is no halo:
    the block's first or last row is the image's, so the kernel's padding is
    right there (reflect; edge on the packed level 1, where one packed row is
    two image rows). The 1x1 conv0, the pools, the upsamples, quantize and
    pack are local: every level keeps an even number of rows a rank
    (:func:`check_geometry`).
  - AdaIN's content statistics span the whole plane: a rank takes the
    partial moments of its rows of each image (K5, ``channel_moments``), the
    ranks merge them (``ops/welford.py::welford_psum``: one all-reduce, the
    same bits on every rank), the unbiased variance over H * W follows, and
    K4's given-statistics entry (``kernels/adain.py::fused_adain_given``)
    restyles the block.

The int8-static route runs the unfused level 1 (conv1_1, conv1_2, dconv1_2
and dconv1_1 as K0 launches), as ``ccst_tpu``'s does: the fused level-1
kernels (K1, K2) chain two convs and would need two halo rows.

K3 and K0 sum each output pixel in the same order wherever its tile sits, so
the sharded convs give the single rank's bits from the same input rows; only
the AdaIN statistics are summed in another order. The batch variant
(:func:`make_batch_stylize_q8s`) has no arithmetic across ranks and gives the
single rank's bits.

No CLI flag reaches these functions, as in ``ccst_tpu``: they are library
entry points (the large-image mode, and the throughput mode of the int8
executor over several cards). Each rank returns its rows of the float32
output; :func:`gather_rows` assembles the whole output on every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from ccst_tpu_torch.kernels.adain import fused_adain, fused_adain_given
from ccst_tpu_torch.kernels.conv import ConvWeights, reflect_conv3x3
from ccst_tpu_torch.kernels.moments import channel_moments
from ccst_tpu_torch.kernels.qconv import qconv3x3_s8
from ccst_tpu_torch.models import vgg, vgg_fast
from ccst_tpu_torch.ops.welford import WelfordState, welford_psum
from ccst_tpu_torch.parallel import multihost

EPS = 1e-5  # AdaIN's, added to the content variance


def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _rank(group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def make_spatial_mesh(n_devices: int, group=None):
    """The process group of ``n_devices`` spatial ranks: ``group`` when given,
    the world when it has that many ranks, else a new group of the world's
    first ``n_devices`` ranks (``new_group`` is collective: every rank of the
    world calls this). ``None`` for one rank of a single process."""
    if group is not None:
        if _size(group) != n_devices:
            raise ValueError(f"the group has {_size(group)} ranks, not {n_devices}")
        return group
    have = multihost.world_size()
    if have < n_devices:
        raise ValueError(f"need {n_devices} ranks, have {have}")
    if not dist.is_initialized():
        return None
    return dist.group.WORLD if have == n_devices else dist.new_group(list(range(n_devices)))


def check_geometry(height: int, n_ranks: int) -> int:
    """The rows a rank holds of an image ``height`` rows high. Raises unless
    H / 8, the relu4_1 height, splits evenly over the ranks with at least 2
    relu4_1 rows a rank (``ccst_tpu``'s rule): every pool and pack then sees
    an even number of rows, and every conv at least 2."""
    if height % (8 * n_ranks) or height // (8 * n_ranks) < 2:
        raise ValueError(
            f"image height {height} does not shard over {n_ranks} spatial ranks: H/8 (the "
            f"relu4_1 height) must be divisible by {n_ranks} with at least 2 relu4_1 rows a "
            f"rank; pad the image or choose another number of ranks")
    return height // n_ranks


def own_rows(images: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of rows of an (N, H, W, C) batch."""
    rows = check_geometry(images.shape[1], _size(group))
    r = _rank(group)
    return images[:, r * rows:(r + 1) * rows]


def gather_rows(block: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's block joined along ``dim`` in rank order (rows: 1; the
    batch variant's images: 0), on every rank."""
    if _size(group) == 1:
        return block
    return torch.cat(multihost.all_gather(block, group), dim=dim)


def exchange_halo(x: torch.Tensor, group) -> Tuple[torch.Tensor, int, int]:
    """(x with the neighbours' edge rows above and below, rows added above,
    rows added below): a rank sends its first row up and its last row down."""
    n, r = _size(group), _rank(group)
    sends: Dict[int, torch.Tensor] = {}
    if r > 0:
        sends[r - 1] = x[:, :1]
    if r < n - 1:
        sends[r + 1] = x[:, -1:]
    if not sends:
        return x, 0, 0
    got = multihost.exchange(sends, sends, group)
    parts = [got[r - 1]] if r > 0 else []
    parts.append(x)
    if r < n - 1:
        parts.append(got[r + 1])
    return torch.cat(parts, dim=1), int(r > 0), int(r < n - 1)


def halo_conv(x: torch.Tensor, conv: Callable[[torch.Tensor], torch.Tensor],
              group) -> torch.Tensor:
    """``conv`` (a 3x3 conv with its own padding) of a block of rows, with the
    halo exchange before and the halo's output rows dropped after."""
    ext, top, bottom = exchange_halo(x, group)
    y = conv(ext)
    if top or bottom:
        y = y[:, top:y.shape[1] - bottom].contiguous()
        if y.data_ptr() % 16:  # the kernels take 16-byte aligned rows
            y = y.clone()
    return y


def whole_plane_stats(feat: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, 1 / sqrt(var + eps)), (N, C) float32, of every image over the
    whole plane that the ranks' blocks make up: one K5 launch an image on
    this rank's rows, the partial moments merged over the group, the
    unbiased (ddof 1) variance over H * W, as K4 forms it."""
    means, invs = [], []
    for i in range(feat.shape[0]):
        mean, m2, count = channel_moments(feat[i:i + 1])
        state = WelfordState(count=count, mean=mean, m2=m2)
        if _size(group) > 1:
            state = welford_psum(state, group)
        var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)
        means.append(state.mean)
        invs.append(torch.rsqrt(var + EPS))
    return torch.stack(means), torch.stack(invs)


def sharded_adain(feat: torch.Tensor, s_mean, s_std, alpha: float, group) -> torch.Tensor:
    """AdaIN + alpha blend of a block of rows by the whole plane's content
    statistics, in the features' dtype."""
    mean, inv_std = whole_plane_stats(feat, group)
    c = feat.shape[-1]
    s_mean = torch.as_tensor(s_mean, dtype=torch.float32, device=feat.device).reshape(1, c)
    s_std = torch.as_tensor(s_std, dtype=torch.float32, device=feat.device).reshape(1, c)
    return fused_adain_given(feat, mean, inv_std, s_mean, s_std, alpha)[0]


def _as_input(images, device, dtype) -> torch.Tensor:
    # uint8 transport as the engines take it: the bytes / 255 in float32
    images = torch.as_tensor(images).to(device)
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    return images.to(dtype)


def _prepared(params, dtype: torch.dtype, device) -> Dict[str, ConvWeights]:
    if all(isinstance(p, ConvWeights) for p in params.values()):
        return params
    return vgg.prepare_params(params, dtype, device)


def make_spatial_stylize(group, dtype=torch.bfloat16, device="cuda"):
    """Returns ``stylize(enc, dec, images, s_mean, s_std, alpha=1.0)``: the
    ``ref`` formula (encode, AdaIN + alpha blend, decode) with the image
    height sharded over ``group``; every 3x3 conv is K3 with halo rows.
    ``enc`` / ``dec`` are ``Params`` (cast to ``dtype`` at each call, as
    ``ccst_tpu``'s are) or ``vgg.prepare_params`` output. Every rank passes
    the whole (N, H, W, 3) batch and gets its rows of the float32 output;
    ``stylize.encode(enc, images)`` gives its rows of the relu4_1 features."""
    dev = torch.device(device)

    def conv(t: torch.Tensor, layer, params) -> torch.Tensor:
        cw = params[layer.name]
        if layer.ksize == 1:
            return vgg.conv1x1(t, cw)
        return halo_conv(t, lambda u: reflect_conv3x3(u, cw, relu=layer.relu), group)

    @torch.no_grad()
    def encode(enc, images) -> torch.Tensor:
        enc = _prepared(enc, dtype, dev)
        x = own_rows(_as_input(images, dev, dtype), group).contiguous()
        return vgg_fast._walk(vgg.ENCODER_ARCH, x, lambda t, layer: conv(t, layer, enc))

    @torch.no_grad()
    def run(enc, dec, images, s_mean, s_std, alpha: float = 1.0) -> torch.Tensor:
        dec = _prepared(dec, dtype, dev)
        t = sharded_adain(encode(enc, images), s_mean, s_std, alpha, group)
        return vgg_fast._walk(vgg.DECODER_ARCH, t, lambda u, layer: conv(u, layer, dec)).float()

    run.encode = encode
    return run


def make_spatial_stylize_q8s(group, enc_prep, dec_prep, dtype=torch.bfloat16):
    """The int8-static executor (``models/vgg_fast.py``) with the image
    height sharded over ``group``: every K0 conv with halo rows, the packed
    level 1 unfused. The static scales are global, so quantize and pack stay
    local. ``enc_prep`` / ``dec_prep``: ``prepare_encoder_q8s`` /
    ``prepare_decoder_q8s`` output (calibrated), on the device that runs it.
    Returns ``stylize(images, s_mean, s_std, alpha=1.0)``: this rank's rows
    of the float32 output; ``stylize.encode(images)``: of the relu4_1
    features."""
    dev = enc_prep["conv0"].w.device

    def qconv(x, q, relu, out_dtype, pad_mode):
        return halo_conv(x, lambda t: qconv3x3_s8(t, q, relu, out_dtype, pad_mode), group)

    @torch.no_grad()
    def encode(images) -> torch.Tensor:
        x = own_rows(_as_input(images, dev, torch.float32), group).contiguous()
        return vgg_fast._encode(enc_prep, x, dtype, False, qconv)

    @torch.no_grad()
    def run(images, s_mean, s_std, alpha: float = 1.0) -> torch.Tensor:
        t = sharded_adain(encode(images), s_mean, s_std, alpha, group)
        return vgg_fast._decode(dec_prep, t, dtype, False, qconv).float()

    run.encode = encode
    return run


def make_batch_stylize_q8s(group, enc_prep, dec_prep, dtype=torch.bfloat16):
    """Batch (data-parallel) sharding of the int8-static executor: each rank
    stylizes its block of the content batch through the single-rank path
    (K0, K4), so the result is the single rank's, bit for bit. Returns
    ``stylize(images, s_mean, s_std, alpha=1.0)``: this rank's images of the
    float32 output (:func:`gather_rows` with ``dim=0`` joins them)."""
    dev = enc_prep["conv0"].w.device

    @torch.no_grad()
    def run(images, s_mean, s_std, alpha: float = 1.0) -> torch.Tensor:
        n, b = _size(group), images.shape[0]
        if b % n:
            raise ValueError(f"batch size {b} not divisible by the {n}-rank spatial group; pad "
                             f"the batch or choose a divisible batch size")
        per = b // n
        r = _rank(group)
        x = _as_input(images[r * per:(r + 1) * per], dev, torch.float32)
        feat = vgg_fast.apply_encoder_q8s(enc_prep, x, dtype)
        t = fused_adain(feat, s_mean, s_std, alpha)
        return vgg_fast.apply_decoder_q8s(dec_prep, t, dtype).float()

    return run

