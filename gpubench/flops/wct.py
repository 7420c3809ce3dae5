"""Counts of WCT universal style transfer (Li et al., arXiv:1705.08086) in
CCST's Overall form, from shapes: the VGG-19 encoder cut at each of the five
levels, the five mirror decoders, and the whitening and colouring transform.

A model FLOP of a conv is 2 x one multiply-accumulate of a 3x3 conv, as
``flops/vgg.py`` counts it (the 1x1 ``conv0``, pools and upsamples left out).
A call of B content images under S banks:

- encodes the batch to relu5_1 once (189.4 GFLOP an image at 512 px);
- for each style decodes from relu5_1 (189.4), then at relu4_1, relu3_1,
  relu2_1 and relu1_1 encodes to the level and decodes from it
  (253.1, 117.8, 59.8 and 1.8 GFLOP): 621.9 GFLOP a content-style pair;
- transforms: the centred Gram ``x_c^T x_c`` of C channels over P positions
  (2 P C^2) once an image at relu5_1 and once a pair at the four finer levels,
  and the apply ``(S W) x_c`` (2 P C^2) once a pair at every level; the
  transform's C x C products (the inverse square root, ``S W``) are the
  algorithm's, not the model's, and are left out.

The transform's kernels are named by :data:`KERNELS`: fragments of the names
of the device kernels that only ``ops/wct.py`` launches on the card: its hand
kernel (``csrc/wct/wct_centre.cu``), cuBLAS's bfloat16 products (the Gram and
the apply; on the H100 with CUDA 12.8 its ``nvjet`` kernels) and its float64
products (the solve). Its means and small elementwise steps run in PyTorch's
generic kernels and are not counted. :func:`centre_split_bytes` counts the
hand kernel's bytes, each read once and each write once.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

from gpubench.flops import BF16_PEAK_FLOPS, bound_s
from gpubench.flops.vgg import DECODER, ENCODER, Conv3, _bf16_conv, pass_flops

LEVELS = ("relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1")
CHANNELS = {"relu5_1": 512, "relu4_1": 512, "relu3_1": 256, "relu2_1": 128, "relu1_1": 64}
DOWN = {"relu5_1": 16, "relu4_1": 8, "relu3_1": 4, "relu2_1": 2, "relu1_1": 1}

ENCODER5: Tuple[Conv3, ...] = ENCODER + (
    Conv3("conv4_2", 512, 512, 8), Conv3("conv4_3", 512, 512, 8), Conv3("conv4_4", 512, 512, 8),
    Conv3("conv5_1", 512, 512, 16),
)
DECODER5: Tuple[Conv3, ...] = (
    Conv3("dconv5_1", 512, 512, 16), Conv3("dconv4_4", 512, 512, 8),
    Conv3("dconv4_3", 512, 512, 8), Conv3("dconv4_2", 512, 512, 8),
) + DECODER
FIRST = {"relu5_1": ("conv5_1", "dconv5_1"), "relu4_1": ("conv4_1", "dconv4_1"),
         "relu3_1": ("conv3_1", "dconv3_1"), "relu2_1": ("conv2_1", "dconv2_1"),
         "relu1_1": ("conv1_1", "dconv1_1")}

# fragments of the names of the transform's device kernels; no other layer of
# a stylize call launches a kernel whose name holds one (the convs are K3, the
# 1x1 conv0 a float32 cuBLAS product)
KERNELS = ("wct_centre_split", "nvjet", "gemm_f64f64")
CENTRE_KERNEL = "wct_centre_split"
PAD = 8  # the columns the centring kernel writes after C


def encoder_to(level: str) -> Tuple[Conv3, ...]:
    names = [c.name for c in ENCODER5]
    return ENCODER5[:names.index(FIRST[level][0]) + 1]


def decoder_from(level: str) -> Tuple[Conv3, ...]:
    names = [c.name for c in DECODER5]
    return DECODER5[names.index(FIRST[level][1]):]


class Job(NamedTuple):
    """One call: ``batch`` content images at ``size`` px under ``styles``
    banks."""

    size: int
    batch: int
    styles: int

    @property
    def images(self) -> int:
        return self.batch * self.styles

    @property
    def solves(self) -> int:
        """Inverse square roots a call: the relu5_1 whitening once an image,
        the four finer levels once a pair."""
        return self.batch * (1 + 4 * self.styles)


def job_of(param) -> Job:
    return Job(param("image_size"), param("batch"), param("styles"))


def pair_conv_flops(size: int) -> float:
    """Conv FLOPs of one content-style pair's cascade after the shared
    relu5_1 encode."""
    out = pass_flops(decoder_from(LEVELS[0]), size)
    for level in LEVELS[1:]:
        out += pass_flops(encoder_to(level), size) + pass_flops(decoder_from(level), size)
    return out


def conv_flops(job: Job) -> float:
    return job.batch * (pass_flops(encoder_to(LEVELS[0]), job.size)
                        + job.styles * pair_conv_flops(job.size))


def positions(level: str, size: int) -> int:
    side = size // DOWN[level]
    return side * side


def transform_flops(job: Job) -> float:
    """Gram and apply FLOPs a call."""
    out = 0.0
    pairs = job.batch * job.styles
    for level in LEVELS:
        grams = job.batch if level == LEVELS[0] else pairs
        out += 2.0 * positions(level, job.size) * CHANNELS[level] ** 2 * (grams + pairs)
    return out


def model_flops(job: Job) -> float:
    return conv_flops(job) + transform_flops(job)


def centre_split_bytes(job: Job) -> float:
    """Device memory the centring kernel moves in one call (bfloat16): per
    position it reads C features and writes C + 8 and C; it reads the B C
    float32 means. Once an image at relu5_1, once a pair at the other four."""
    total = 0.0
    for level in LEVELS:
        c, p = CHANNELS[level], positions(level, job.size)
        per_image = 2.0 * p * (c + (c + PAD) + c) + 4.0 * c
        total += per_image * job.batch * (1 if level == LEVELS[0] else job.styles)
    return total


def k3_bound_s(job: Job) -> float:
    """The least time a call's K3 launches could take: one bfloat16 launch a
    3x3 conv of :func:`conv_flops`'s passes at batch ``job.batch``, each the
    larger of its operations at the bfloat16 peak and its bytes (input,
    weights and output moved once, ``flops/vgg.py``'s count) at the memory
    rate."""
    passes = [encoder_to(LEVELS[0])] + [decoder_from(LEVELS[0])] * job.styles
    for level in LEVELS[1:]:
        passes += [encoder_to(level), decoder_from(level)] * job.styles
    return sum(bound_s(*_bf16_conv(c, job.size, job.batch), BF16_PEAK_FLOPS)
               for convs in passes for c in convs)
