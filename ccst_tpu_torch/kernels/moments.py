"""Per-channel moments of an NHWC batch: CUDA kernel wrapper and plain version.

Replaces ``ccst_tpu/kernels/welford_pallas.py::channel_moments`` (K5), the
per-batch reduction of the style-bank step: the float32 mean and M2 (sum of
squared deviations from the mean) of every channel over N*H*W, and the count.
The result is exactly what ``ops.welford.welford_merge`` consumes. The kernel
is ``csrc/moments.cu`` (built by ``kernels/_build.py``): one launch; its
header says what bounds it on the H100 and how the design answers that. There
is no ``C % 128`` rule.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ccst_tpu_torch.kernels import refuse_autograd
from ccst_tpu_torch.kernels.resident_slice import block_sum, channel_groups

# rows a block keeps resident (64 KB). One size serves every shape: measured by
# benchmarks/small_kernels.py on an H100, it is the fastest or within 7% of the
# fastest of 128, 256, 512 and 1024 at every shape of the bank step.
CHUNK = 512
SEGMENTS = 4              # threads a channel in the kernel's merge


class MomentsPlan(NamedTuple):
    """How the kernel splits the flattened (rows, C) matrix."""

    chunk: int    # rows of a block; the last chunk may hold fewer
    nchunks: int
    groups: int   # 128-byte channel groups of a row


def plan_moments(rows: int, c: int, itemsize: int) -> MomentsPlan:
    """The partition, from the shape alone: ``CHUNK`` rows x one channel group
    a block."""
    return MomentsPlan(CHUNK, -(-rows // CHUNK), channel_groups(c, itemsize))


def channel_moments_reference(
    feat: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: two-pass float32 mean and M2 over the whole batch."""
    c = feat.shape[-1]
    x = feat.float().reshape(-1, c)
    mean = x.mean(dim=0)
    m2 = torch.square(x - mean).sum(dim=0)
    count = torch.full((), float(x.shape[0]), device=feat.device)
    return mean, m2, count


def _chan_merge(a, b):
    """Chan's merge of (n, mean, M2) ``b`` into ``a`` in float32, as the kernel's."""
    (na, mean_a, m2_a), (nb, mean_b, m2_b) = a, b
    n = na + nb
    delta = mean_b - mean_a
    return n, mean_a + delta * (nb / n), m2_a + m2_b + delta * delta * (na * nb / n)


def simulate_moments(feat: np.ndarray, itemsize: int = 4) -> Tuple[np.ndarray, np.ndarray, float]:
    """Numpy model of the kernel's partition on a float32 (..., C) batch: every
    chunk's mean and centred squares from block sums in the kernel's order
    (``resident_slice.block_sum``), then the chunks Chan-merged in chunk
    order: each of ``SEGMENTS`` runs of chunks in order, then the runs in
    order. Returns (mean, M2, count)."""
    c = feat.shape[-1]
    x = np.asarray(feat, np.float32).reshape(-1, c)
    plan = plan_moments(x.shape[0], c, itemsize)
    parts = []
    for i in range(plan.nchunks):
        rows = x[i * plan.chunk:(i + 1) * plan.chunk]
        n = np.float32(len(rows))
        mean = block_sum(rows) / n
        parts.append((n, mean, block_sum(np.square(rows - mean))))
    per = -(-plan.nchunks // SEGMENTS)
    runs = []
    for s in range(SEGMENTS):
        run = parts[s * per:(s + 1) * per]
        if run:
            acc = run[0]
            for part in run[1:]:
                acc = _chan_merge(acc, part)
            runs.append(acc)
    acc = runs[0]
    for run in runs[1:]:
        acc = _chan_merge(acc, run)
    return acc[1], acc[2], float(x.shape[0])


# per device: the kernel's ticket counters, zero between launches
_tickets: Dict[torch.device, torch.Tensor] = {}


def _tickets_for(device: torch.device, groups: int) -> torch.Tensor:
    """The zeroed int32 tickets the kernel draws from, one per channel group.
    The merging block resets them, so they are filled once, not per launch.
    One buffer serves a device: launches there are taken to follow each other
    in stream order, as the port's are (it uses one stream a device)."""
    held = _tickets.get(device)
    if held is None or held.numel() < groups:
        if torch.cuda.is_current_stream_capturing():
            # memory made during capture belongs to the graph's pool
            raise RuntimeError("channel_moments: call it once at this channel count "
                               "before capturing it into a CUDA graph")
        held = torch.zeros((max(groups, 256),), dtype=torch.int32, device=device)
        _tickets[device] = held
    return held


def channel_moments(feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, m2, count) in float32: (C,), (C,) and a scalar. Raises if
    ``feat`` requires grad under grad mode: the kernel has no backward."""
    refuse_autograd("channel_moments", feat)
    if feat.device.type == "cpu":
        return channel_moments_reference(feat)
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"channel_moments takes bfloat16 or float32, got {feat.dtype}")
    if not feat.is_contiguous():
        raise ValueError("channel_moments takes a contiguous NHWC tensor")
    c = feat.shape[-1]
    rows = feat.numel() // c if c else 0
    if rows == 0:
        raise ValueError("channel_moments needs at least one row")
    from ccst_tpu_torch.kernels import _build

    lib = _build.library()
    plan = plan_moments(rows, c, feat.element_size())
    dev = feat.device
    partials = torch.empty((2, plan.nchunks, c), dtype=torch.float32, device=dev)
    out = torch.empty((2 * c + 1,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ccst_channel_moments(
            feat.data_ptr(), partials.data_ptr(), out.data_ptr(),
            _tickets_for(dev, plan.groups).data_ptr(), rows, c, plan.chunk,
            int(feat.dtype == torch.float32), stream,
        )
    if rc:
        raise RuntimeError(f"channel_moments launch failed: CUDA error {rc}")
    channel_moments.launches += 1
    return out[:c], out[c:2 * c], out[2 * c]


channel_moments.launches = 0
