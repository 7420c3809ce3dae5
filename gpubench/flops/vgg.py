"""Counts of the AdaIN stylizer: the VGG-19 encoder to relu4_1 and its mirror
decoder (Huang & Belongie, arXiv:1703.06868), from shapes.

A model FLOP is 2 x one multiply-accumulate of a 3x3 conv; the 1x1 ``conv0``
(3 -> 3 channels), the pools, the upsamples and AdaIN are left out, so one
encoder pass of a 512 px image is 126.53 GFLOP and so is one decoder pass.

Kernel work is counted per launch group of the port's engines, with each input
byte read once and each output byte written once:

- ``ref``: every 3x3 conv is one K3 launch in bfloat16;
- ``int8-fused``: K1 runs conv1_1 + conv1_2 + pool1, K0 every other 3x3 conv
  (int8 in; int8 out, or bfloat16 where it dequantizes: conv4_1), K2 runs
  dconv1_2 + dconv1_1 (the last upsample folded in, bfloat16 out);
- Single mode's style image goes through the ``ref`` encoder (K3) at batch 1.

The operations counted are the model's, whatever layout a kernel computes in.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

from gpubench.flops import BF16_PEAK_FLOPS, INT8_PEAK_OPS, bound_s


class Conv3(NamedTuple):
    name: str
    cin: int
    cout: int
    down: int   # the plane is (size / down) square

    def macs(self, size: int) -> int:
        side = size // self.down
        return side * side * 9 * self.cin * self.cout


ENCODER: Tuple[Conv3, ...] = (
    Conv3("conv1_1", 3, 64, 1), Conv3("conv1_2", 64, 64, 1),
    Conv3("conv2_1", 64, 128, 2), Conv3("conv2_2", 128, 128, 2),
    Conv3("conv3_1", 128, 256, 4), Conv3("conv3_2", 256, 256, 4),
    Conv3("conv3_3", 256, 256, 4), Conv3("conv3_4", 256, 256, 4),
    Conv3("conv4_1", 256, 512, 8),
)
DECODER: Tuple[Conv3, ...] = (
    Conv3("dconv4_1", 512, 256, 8),
    Conv3("dconv3_4", 256, 256, 4), Conv3("dconv3_3", 256, 256, 4),
    Conv3("dconv3_2", 256, 256, 4), Conv3("dconv3_1", 256, 128, 4),
    Conv3("dconv2_2", 128, 128, 2), Conv3("dconv2_1", 128, 64, 2),
    Conv3("dconv1_2", 64, 64, 1), Conv3("dconv1_1", 64, 3, 1),
)


def pass_flops(convs, size: int) -> float:
    """Model FLOPs of one image through ``convs`` at ``size`` px."""
    return 2.0 * sum(c.macs(size) for c in convs)


class Job(NamedTuple):
    """One call of the stylizer: a content batch under ``styles`` style banks
    (Overall) or under one style image's statistics (Single)."""

    size: int
    batch: int
    styles: int
    single: bool

    @property
    def images(self) -> int:
        """Stylized images the call returns."""
        return self.batch * (1 if self.single else self.styles)

    @property
    def decodes(self) -> int:
        return 1 if self.single else self.styles


def job_of(param) -> Job:
    """The call a run makes; ``param`` looks up a traffic or configuration
    key (``harness.Run.param``)."""
    return Job(param("image_size"), param("batch"), param("styles"), param("mode") == "single")


def model_flops(job: Job) -> float:
    """Model FLOPs of one call: one encode of the batch, one decode a style,
    and in Single mode the style image's encode."""
    enc, dec = pass_flops(ENCODER, job.size), pass_flops(DECODER, job.size)
    flops = job.batch * (enc + job.decodes * dec)
    return flops + (enc if job.single else 0.0)


def _bf16_conv(c: Conv3, size: int, n: int) -> Tuple[float, float]:
    side = size // c.down
    px = n * side * side
    return 2.0 * n * c.macs(size), 2.0 * px * (c.cin + c.cout) + 2.0 * 9 * c.cin * c.cout + 4.0 * c.cout


def _int8_conv(c: Conv3, size: int, n: int, out_bytes: int) -> Tuple[float, float]:
    side = size // c.down
    px = n * side * side
    return 2.0 * n * c.macs(size), px * (c.cin + out_bytes * c.cout) + 9.0 * c.cin * c.cout + 8.0 * c.cout


def launches(engine: str, job: Job) -> List[Tuple[str, float, float]]:
    """(kernel id, operations, bytes) of every kernel launch of one call that
    computes a 3x3 conv."""
    out: List[Tuple[str, float, float]] = []
    n, size = job.batch, job.size
    if job.single:  # the style image's statistics: the ref encoder at batch 1
        out += [("K3", *_bf16_conv(c, size, 1)) for c in ENCODER]
    if engine == "ref":
        out += [("K3", *_bf16_conv(c, size, n)) for c in ENCODER]
        out += [("K3", *_bf16_conv(c, size, n)) for c in DECODER] * job.decodes
        return out
    if engine != "int8-fused":
        raise ValueError(f"no kernel counts for engine {engine!r}")
    by_name = {c.name: c for c in ENCODER + DECODER}
    c11, c12 = by_name["conv1_1"], by_name["conv1_2"]
    half = size // 2
    out.append(("K1", 2.0 * n * (c11.macs(size) + c12.macs(size)),
                n * size * size * 3 + n * half * half * 64
                + 9.0 * (3 * 64 + 64 * 64) + 8.0 * 128))
    for c in ENCODER[2:]:
        out.append(("K0", *_int8_conv(c, size, n, 2 if c.name == "conv4_1" else 1)))
    dec = [("K0", *_int8_conv(c, size, n, 1)) for c in DECODER[:-2]]
    d12, d11 = by_name["dconv1_2"], by_name["dconv1_1"]
    dec.append(("K2", 2.0 * n * (d12.macs(size) + d11.macs(size)),
                n * half * half * 64 + 2.0 * n * size * size * 3
                + 9.0 * (64 * 64 + 64 * 3) + 8.0 * 67))
    return out + dec * job.decodes


def kernel_bound_s(engine: str, job: Job, kernels) -> float:
    """The least time the launches of ``kernels`` in one call could take:
    per launch the larger of its operations at the peak of its precision
    (bfloat16 for K3, int8 for K0 / K1 / K2) and its bytes at the memory
    rate."""
    peak = {"K3": BF16_PEAK_FLOPS, "K0": INT8_PEAK_OPS, "K1": INT8_PEAK_OPS,
            "K2": INT8_PEAK_OPS}
    return sum(bound_s(ops, nbytes, peak[k]) for k, ops, nbytes in launches(engine, job)
               if k in kernels)
