"""Robust penalties rho(s) on the squared residual s, with derivatives (frozen
copy of the port's `core.penalty`). Ids follow the reference: 0 quadratic, 1
modified L1 (default), 2 Lorentzian, 3 truncated modified L1, 4 Geman-
McClure.

The CUDA kernels evaluate the same functions from (fct, eps_sq, trunc,
trunc_value) — `Penalty.kernel_args` hands them over.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Penalty:
    fct: int
    eps: float = 0.001
    trunc: float = 0.5

    @property
    def eps_sq(self) -> float:
        return float(self.eps) * float(self.eps)

    @property
    def trunc_value(self) -> float:
        """rho beyond the truncation, sqrt(trunc + eps^2) in float32."""
        return float(np.sqrt(np.float32(self.trunc + self.eps_sq)))

    def kernel_args(self) -> tuple[float, float, float, float]:
        return (float(self.fct), self.eps_sq, float(self.trunc),
                self.trunc_value)

    def apply(self, s: torch.Tensor) -> torch.Tensor:
        e2 = self.eps_sq
        if self.fct == 0:
            return s
        if self.fct == 2:
            return torch.log1p(0.5 * s / e2)
        if self.fct == 3:
            return torch.where(torch.sqrt(s) > self.trunc,
                               torch.full_like(s, self.trunc_value),
                               torch.sqrt(s + e2))
        if self.fct == 4:
            return s / ((s + 1.0) * (s + 1.0))
        return torch.sqrt(s + e2)

    def derivative(self, s: torch.Tensor) -> torch.Tensor:
        e2 = self.eps_sq
        if self.fct == 0:
            return torch.ones_like(s)
        if self.fct == 2:
            return 1.0 / (2.0 * e2 + s)
        if self.fct == 3:
            return torch.where(torch.sqrt(s) > self.trunc,
                               torch.zeros_like(s),
                               1.0 / (2.0 * torch.sqrt(s + e2)))
        if self.fct == 4:
            return (e2 + 2.0 * s) / ((e2 + s) * (e2 + s))
        return 1.0 / (2.0 * torch.sqrt(s + e2))


def make_penalty(fct: int, eps: float = 0.001, trunc: float = 0.5) -> Penalty:
    return Penalty(int(fct), float(eps), float(trunc))
