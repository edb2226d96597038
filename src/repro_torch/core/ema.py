"""Exponential-moving-average mean/variance tracker (port of
``repro/core/ema.py``; paper Eqs. 7-8 + the de-biasing of Alg. 1 line 8).

    M_n = (1-a) M_{n-1} + a x_n
    V_n = (1-a) V_{n-1} + a (x_n - M_n)^2
    V'_n = V_n / (1 - (1-a)^n)

Vectorised over a batch of trackers, one per in-flight sequence.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class EMAState(NamedTuple):
    mean: torch.Tensor     # (B,) float32
    var: torch.Tensor      # (B,) float32
    count: torch.Tensor    # (B,) int32 — updates seen


def ema_init(batch: int, device) -> EMAState:
    return EMAState(
        mean=torch.zeros((batch,), dtype=torch.float32, device=device),
        var=torch.zeros((batch,), dtype=torch.float32, device=device),
        count=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def ema_update(state: EMAState, x: torch.Tensor, alpha: float,
               active: torch.Tensor | None = None) -> EMAState:
    """One update per sequence; sequences with active=False are frozen."""
    m = (1.0 - alpha) * state.mean + alpha * x
    v = (1.0 - alpha) * state.var + alpha * (x - m) ** 2
    c = state.count + 1
    if active is not None:
        m = torch.where(active, m, state.mean)
        v = torch.where(active, v, state.var)
        c = torch.where(active, c, state.count)
    return EMAState(mean=m, var=v, count=c)


def ema_debiased_var(state: EMAState, alpha: float) -> torch.Tensor:
    """V'_n; inf where no updates yet (never stops before the first
    evaluation)."""
    n = state.count.clamp_min(1).float()
    denom = 1.0 - torch.pow(torch.full((), 1.0 - alpha, device=n.device), n)
    v = state.var / denom.clamp_min(1e-12)
    return torch.where(state.count > 0, v, torch.inf)
