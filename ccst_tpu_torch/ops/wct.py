"""The whitening and colouring transform (WCT) of universal style transfer
(Li et al., arXiv:1705.08086), batched on the device.

At one level, for content features ``f_c`` (B, H, W, C) and a style given by
its mean ``m_s`` (C,) and colouring matrix ``S_s^1/2`` (C, C)::

    x_c   = f_c - m_c                              (per image, over H W)
    C_c   = x_c^T x_c / (HW - 1) + I                (the centred Gram; +I as PytorchWCT)
    W_c   = C_c^-1/2                                (symmetric: E D^-1/2 E^T)
    f_cs  = (S_s^1/2 W_c) x_c + m_s
    out   = alpha f_cs + (1 - alpha) f_c

The three parts do three kinds of work: the Gram is one C x C product over
every position of an image, the inverse square root is small dense linear
algebra on a batch of C x C matrices, and the apply is one C x C by C x HW
product after ``S_s^1/2 W_c`` is folded into one matrix.

Precision: the Gram is float32's, the solve float64's, the apply the
compute dtype's. One pass (``kernels/wct.py::centre_split``) writes the centred
features ``d`` rounded to the compute dtype (``hi``, with two columns of ones
after them) and, in bfloat16, the rest ``lo = d - hi``; the Gram is
``hi^T hi + hi^T lo + lo^T hi``, bfloat16 products summed in float32 on the
tensor cores over runs of ``GRAM_RUN`` positions and the runs in float64
(:func:`gram64`), within ~2^-16 of ``d``'s own Gram (``hi``'s alone is not
enough: after ``+ I`` at VGG's feature scale, ~1e4 on the diagonal, a Gram
rounded to bfloat16 is indefinite). The solve is float64: its matrices are
small and the card's float64 rate matches its float32 rate outside the
tensor cores. The apply is one product ``[hi | 1 1] @ [T^T; m_hi; m_lo]``
summed in float32 and rounded once, the style mean added in its sums.

The inverse square root is a coupled Newton-Schulz iteration
(:func:`inv_sqrt`): batched matrix products only, a fixed number of them, so
a call never waits on the host and never loops over matrices. ``+ I`` puts
every eigenvalue of ``C_c`` at 1 or above, so after scaling by the Frobenius
norm the spectrum lies in ``[1 / ||C_c||_F, 1]`` and the iteration converges
from any content. The style side is solved once, when the bank is made
(:func:`colour_of`: an eigendecomposition in float64, eigenvalues at or below
``STYLE_EIG_CUT`` dropped, as PytorchWCT does).

While a profiler is active, ``stylize.wct_solve`` spans the inverse square
roots (the engine spans a whole transform as ``stylize.wct``),
``wct.solves`` counts the matrices solved and ``wct.gram_bytes`` the bytes
the Gram reads.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

import torch

from ccst_tpu_torch.kernels.wct import PAD, centre_split
from ccst_tpu_torch.utils import profiling
from ccst_tpu_torch.utils.profiling import span

STYLE_EIG_CUT = 1e-5
# Newton-Schulz steps: the smallest scaled eigenvalue grows by about 9/4 a
# step until it nears 1, then the error squares; at 512 px the contents'
# ||C_c||_F / lambda_min reach ~1e5, converged by 20 steps (PERF.md), and
# each step more allows 2.25 times the spread
NS_ITERS = 24
# positions a float32 sum of the Gram runs over before its partial sums are
# added in float64: one float32 sum over the 262,144 positions of a 512 px
# relu1_1 map loses enough to move the small eigenvalues (~1, from +I) of a
# covariance whose largest reach ~2e4
GRAM_RUN = 4096


@contextmanager
def _exact_sums() -> Iterator[None]:
    """float32 products in float32 (no TF32) and bfloat16 products summed in
    float32 throughout (no reduced-precision split-K), restored afterwards."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, summed in float32 into a float32 result; bfloat16
    operands stay bfloat16 on the card (the tensor cores' products of them
    are exact)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def centre(feat: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, H, W, C) -> ``centre_split``'s ``(hi, lo)`` of the features less
    their per-image channel means."""
    x = feat.reshape(feat.shape[0], -1, feat.shape[-1])
    return centre_split(x, x.mean(dim=1, dtype=torch.float32))


def gram64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T b`` of (B, P, Ca) and (B, P, Cb) -> (B, Ca, Cb) float64: the
    products summed in float32 over runs of ``GRAM_RUN`` positions (one
    batched product), the runs' sums added in float64."""
    bsz, p = a.shape[:2]
    k = p // GRAM_RUN
    if k <= 1:
        return bmm_f32(a.transpose(1, 2), b).double()
    n = k * GRAM_RUN
    runs = bmm_f32(a[:, :n].reshape(bsz * k, GRAM_RUN, -1).transpose(1, 2),
                   b[:, :n].reshape(bsz * k, GRAM_RUN, -1))
    out = runs.view(bsz, k, *runs.shape[1:]).double().sum(dim=1)
    if n < p:
        out += bmm_f32(a[:, n:].transpose(1, 2), b[:, n:]).double()
    return out


def content_cov(hi: torch.Tensor, lo: Optional[torch.Tensor]) -> torch.Tensor:
    """``d^T d / (P - 1) + I`` (B, C, C) in float64 from ``centre``'s split."""
    c = hi.shape[-1] - PAD
    if profiling.active():
        profiling.count("wct.gram_bytes", hi.nbytes + (0 if lo is None else lo.nbytes))
    gram = gram64(hi, hi)[:, :c, :c]
    if lo is not None:
        cross = gram64(hi, lo)[:, :c]
        gram = gram + cross + cross.transpose(1, 2)
    cov = gram / (hi.shape[1] - 1)
    return cov + torch.eye(c, device=cov.device, dtype=cov.dtype)


def inv_sqrt(a: torch.Tensor, iters: int = NS_ITERS) -> torch.Tensor:
    """``a^-1/2`` of a batch (B, C, C) of symmetric positive definite
    matrices whose eigenvalues are all at least 1: the coupled Newton-Schulz
    iteration ``T = (3 I - Z Y) / 2, Y <- Y T, Z <- T Z`` from ``Y = a / n``,
    ``Z = I``, with ``n`` the Frobenius norm; ``Z`` tends to ``(a / n)^-1/2``."""
    n = a.flatten(1).norm(dim=1)[:, None, None]
    eye = torch.eye(a.shape[-1], device=a.device, dtype=a.dtype).expand_as(a)
    y, z = a / n, eye.clone()
    for _ in range(iters):
        t = torch.baddbmm(eye, z, y, beta=1.5, alpha=-0.5)
        y, z = torch.bmm(y, t), torch.bmm(t, z)
    return z / n.sqrt()


def whiten(feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Content features (B, H, W, C) -> (``hi`` (B, HW, C + 8), ``W_c``
    (B, C, C) float64)."""
    with _exact_sums():
        hi, lo = centre(feat)
        cov = content_cov(hi, lo)
        with span("stylize.wct_solve"):
            w = inv_sqrt(cov)
        profiling.count("wct.solves", w.shape[0])
    return hi, w


def colour(feat: torch.Tensor, hi: torch.Tensor, w: torch.Tensor, s_mean: torch.Tensor,
           s_colour: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """The whitened content ``W_c d`` coloured by one style's ``S_s^1/2``
    (C, C, float64) and mean (C,) float32, blended with ``feat`` by
    ``alpha``: (B, H, W, C) in ``feat``'s dtype."""
    b, c = w.shape[0], w.shape[-1]
    with _exact_sums():
        tt = torch.zeros((b, c + PAD, c), dtype=hi.dtype, device=hi.device)
        tt[:, :c] = torch.matmul(s_colour, w).transpose(1, 2)
        m_hi = s_mean.to(hi.dtype)
        tt[:, c] = m_hi
        tt[:, c + 1] = s_mean - m_hi.float()
        out = torch.bmm(hi, tt)
        if alpha != 1.0:
            out = (alpha * out.float() + (1.0 - alpha) * feat.reshape(out.shape).float()
                   ).to(feat.dtype)
    return out.reshape(feat.shape)


def colour_of(cov: torch.Tensor) -> torch.Tensor:
    """A style covariance (C, C) -> ``S^1/2 = E D^1/2 E^T`` over the
    eigenvalues above ``STYLE_EIG_CUT``, in float64 (made once a bank)."""
    e, v = torch.linalg.eigh(cov.double())
    root = torch.where(e > STYLE_EIG_CUT, e.clamp_min(0).sqrt(), torch.zeros_like(e))
    return (v * root) @ v.T
