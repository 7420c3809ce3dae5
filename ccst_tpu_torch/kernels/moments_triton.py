"""Triton kernels: per-channel moments of an NHWC batch (the body of
``kernels/moments.py``).

Imported only by :func:`ccst_tpu_torch.kernels.moments.channel_moments` when
it launches on a CUDA tensor, since importing it imports ``triton``.

Replaces ``ccst_tpu/kernels/welford_pallas.py::_moments_kernel``. On the H100
the op is bound by device memory. The TPU kernel carried its accumulator from
one grid step to the next; blocks here run in no order, so the work is split
in two launches and no atomics: ``moments_partial_kernel`` gives every chunk of
CHUNK rows of the flattened (rows, C) matrix its own two-pass mean and M2, and
``moments_merge_kernel`` Chan-merges the chunks in a fixed order, so a style
bank is bit-reproducible from run to run.
"""
import triton
import triton.language as tl


@triton.jit
def moments_partial_kernel(
    x_ptr, pmean_ptr, pm2_ptr, R, C, CHUNK,
    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
):
    pid_r = tl.program_id(0)
    pid_c = tl.program_id(1)
    c = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
    c_ok = c < C
    r0 = pid_r * CHUNK
    count = tl.minimum(CHUNK, R - r0).to(tl.float32)
    rows = tl.arange(0, BLOCK_R)

    total = tl.zeros([BLOCK_C], dtype=tl.float32)
    for start in range(0, CHUNK, BLOCK_R):
        r = r0 + start + rows
        ok = (r < R)[:, None] & c_ok[None, :]
        offs = r.to(tl.int64)[:, None] * C + c[None, :]
        x = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        total += tl.sum(x, axis=0)
    mean = total / count

    sq = tl.zeros([BLOCK_C], dtype=tl.float32)
    for start in range(0, CHUNK, BLOCK_R):
        r = r0 + start + rows
        ok = (r < R)[:, None] & c_ok[None, :]
        offs = r.to(tl.int64)[:, None] * C + c[None, :]
        x = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        d = tl.where(ok, x - mean[None, :], 0.0)
        sq += tl.sum(d * d, axis=0)

    tl.store(pmean_ptr + pid_r * C + c, mean, mask=c_ok)
    tl.store(pm2_ptr + pid_r * C + c, sq, mask=c_ok)


@triton.jit
def moments_merge_kernel(
    pmean_ptr, pm2_ptr, mean_ptr, m2_ptr, R, C, CHUNK, n_chunks,
    BLOCK_C: tl.constexpr,
):
    pid_c = tl.program_id(0)
    c = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
    c_ok = c < C
    mean = tl.load(pmean_ptr + c, mask=c_ok, other=0.0)
    m2 = tl.load(pm2_ptr + c, mask=c_ok, other=0.0)
    n_a = tl.minimum(CHUNK, R).to(tl.float32)
    for i in range(1, n_chunks):
        n_b = tl.minimum(CHUNK, R - i * CHUNK).to(tl.float32)
        mean_b = tl.load(pmean_ptr + i * C + c, mask=c_ok, other=0.0)
        m2_b = tl.load(pm2_ptr + i * C + c, mask=c_ok, other=0.0)
        n = n_a + n_b
        delta = mean_b - mean
        mean = mean + delta * (n_b / n)
        m2 = m2 + m2_b + delta * delta * (n_a * n_b / n)
        n_a = n
    tl.store(mean_ptr + c, mean, mask=c_ok)
    tl.store(m2_ptr + c, m2, mask=c_ok)
