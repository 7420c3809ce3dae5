"""``optax.adam`` and ``optax.adabelief``, written out for lists of tensors.

The trainers of ``ccst_tpu`` use optax's transforms; torch has no AdaBelief,
and its ``Adam`` takes the bias correction in another order. These follow
optax term by term: the moments as ``(1 - b) * g**k + b * m``, the bias
correction ``1 - b**count`` formed in float32, then

  adam:      u = -lr * m_hat / (sqrt(v_hat + eps_root) + eps)   (eps 1e-8, eps_root 0)
  adabelief: s = b2 * s + (1 - b2) * (g - m)**2 + eps_root      (m the new first moment)
             u = -lr * m_hat / (sqrt(s_hat) + eps)              (eps 1e-16, eps_root 1e-16)

and ``p + u`` as ``optax.apply_updates``.
"""
from __future__ import annotations

from typing import Sequence

import torch


class _Optimizer:
    def __init__(self, params: Sequence[torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float, eps_root: float):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.eps_root = lr, b1, b2, eps, eps_root
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _correction(self, decay: float, like: torch.Tensor) -> torch.Tensor:
        c = 1 - torch.tensor(decay, dtype=torch.float32) ** self.count
        return c.to(like.dtype).to(like.device)

    def _second(self, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _denominator(self, nu_hat: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update from ``grads`` (in the order of ``params``) in place."""
        self.count += 1
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu = (1 - self.b1) * g + self.b1 * self.mu[i]
            nu = self._second(g, mu, self.nu[i])
            mu_hat = mu / self._correction(self.b1, mu)
            nu_hat = nu / self._correction(self.b2, nu)
            p.add_((-self.lr * (mu_hat / self._denominator(nu_hat))).to(p.dtype))
            self.mu[i], self.nu[i] = mu, nu


class Adam(_Optimizer):
    """``optax.adam(lr, b1, b2, eps, eps_root)``."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        super().__init__(params, lr, b1, b2, eps, eps_root)

    def _second(self, g, mu, nu):
        return (1 - self.b2) * g ** 2 + self.b2 * nu

    def _denominator(self, nu_hat):
        return torch.sqrt(nu_hat + self.eps_root) + self.eps


class AdaBelief(_Optimizer):
    """``optax.adabelief(lr, b1, b2, eps, eps_root)``."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-16, eps_root: float = 1e-16):
        super().__init__(params, lr, b1, b2, eps, eps_root)

    def _second(self, g, mu, nu):
        return (1 - self.b2) * (g - mu) ** 2 + self.b2 * nu + self.eps_root

    def _denominator(self, nu_hat):
        return torch.sqrt(nu_hat) + self.eps

