"""Triton kernel: fused AdaIN over NHWC features (the body of ``kernels/adain.py``).

Imported only by :func:`ccst_tpu_torch.kernels.adain.fused_adain` when it
launches on a CUDA tensor, since importing it imports ``triton``.

Replaces ``ccst_tpu/kernels/adain_pallas.py::_adain_kernel``. On the H100 the
op is bound by device memory: a few flops per element. One program owns one
image and BLOCK_C channels and walks the H*W rows in masked blocks three times:
the mean, the centred sum of squares (so the variance never comes from
sum(x^2)), and the output. The image's channel slice is read three times, but
at the relu4_1 shape the whole feature map fits in the 50 MB L2, so device
memory sees about one read and one write.
"""
import triton
import triton.language as tl


@triton.jit
def adain_kernel(
    x_ptr, y_ptr, s_mean_ptr, s_std_ptr, alpha, eps, HW, C, n_var,
    BLOCK_HW: tl.constexpr, BLOCK_C: tl.constexpr,
):
    pid_n = tl.program_id(0)
    pid_c = tl.program_id(1)
    c = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
    c_ok = c < C
    base = pid_n.to(tl.int64) * HW * C
    rows = tl.arange(0, BLOCK_HW)

    total = tl.zeros([BLOCK_C], dtype=tl.float32)
    for start in range(0, HW, BLOCK_HW):
        r = start + rows
        ok = (r < HW)[:, None] & c_ok[None, :]
        offs = base + r.to(tl.int64)[:, None] * C + c[None, :]
        x = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        total += tl.sum(x, axis=0)
    mean = total / HW

    sq = tl.zeros([BLOCK_C], dtype=tl.float32)
    for start in range(0, HW, BLOCK_HW):
        r = start + rows
        ok = (r < HW)[:, None] & c_ok[None, :]
        offs = base + r.to(tl.int64)[:, None] * C + c[None, :]
        x = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        d = tl.where(ok, x - mean[None, :], 0.0)
        sq += tl.sum(d * d, axis=0)
    inv_std = 1.0 / tl.sqrt_rn(sq / n_var + eps)

    s_mean = tl.load(s_mean_ptr + c, mask=c_ok, other=0.0)
    s_std = tl.load(s_std_ptr + c, mask=c_ok, other=0.0)
    for start in range(0, HW, BLOCK_HW):
        r = start + rows
        ok = (r < HW)[:, None] & c_ok[None, :]
        offs = base + r.to(tl.int64)[:, None] * C + c[None, :]
        x = tl.load(x_ptr + offs, mask=ok, other=0.0).to(tl.float32)
        styl = (x - mean[None, :]) * inv_std[None, :] * s_std[None, :] + s_mean[None, :]
        out = alpha * styl + (1.0 - alpha) * x
        tl.store(y_ptr + offs, out.to(y_ptr.dtype.element_ty), mask=ok)
