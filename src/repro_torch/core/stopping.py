"""EAT early-exit rule (port of ``EATStopper`` from
``repro/core/stopping.py``; paper Alg. 1): stop when the de-biased EMA
variance of EAT falls below delta.  The other stoppers of the reference
are not on the serving path and are not ported yet."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.ema import EMAState, ema_debiased_var, ema_init, ema_update


class EATState(NamedTuple):
    ema: EMAState
    last: torch.Tensor     # (B,) last signal value (for logging)


@dataclasses.dataclass(frozen=True)
class EATStopper:
    alpha: float = 0.2
    delta: float = 1e-3

    def init(self, batch: int, device) -> EATState:
        return EATState(ema=ema_init(batch, device),
                        last=torch.zeros((batch,), dtype=torch.float32,
                                         device=device))

    def update(self, state: EATState, eat: torch.Tensor, active=None) -> EATState:
        ema = ema_update(state.ema, eat, self.alpha, active)
        last = eat if active is None else torch.where(active, eat, state.last)
        return EATState(ema=ema, last=last)

    def debiased_var(self, state: EATState) -> torch.Tensor:
        return ema_debiased_var(state.ema, self.alpha)

    def should_stop(self, state: EATState) -> torch.Tensor:
        return self.debiased_var(state) < self.delta
