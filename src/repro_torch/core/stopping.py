"""Early-exit stopping rules (port of ``repro/core/stopping.py``; paper
Algs. 1-3 + the confidence baseline).

Every stopper has the functional interface the device loop needs (state
tensors, decisions as masks, no host read):

    state = stopper.init(batch, device)
    state = stopper.update(state, signal, active)   # per evaluation point
    stop  = stopper.should_stop(state)              # (B,) bool

* ``EATStopper``          — Alg. 1: EMA variance of EAT below delta (the
  serving path's stopper, inside the decode chunk).
* ``TokenBudgetStopper``  — Alg. 2: a fixed per-question token limit T.
* ``UniqueAnswerStopper`` — Alg. 3 (#UA@K): distinct answers among K forced
  rollouts <= Delta (the engine's ``rollout_answers`` supplies them).
* ``ConfidenceStopper``   — Yang et al. 2025b (Eq. 16): EMA variance of the
  length-normalised likelihood of a greedy T'-token rollout.
* ``GiveUpStopper``       — the paper's §6 future work: abandon a question
  whose EAT variance stalls above a ceiling.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.ema import EMAState, ema_debiased_var, ema_init, ema_update


class EATState(NamedTuple):
    ema: EMAState
    last: torch.Tensor     # (B,) last signal value (for logging)


def _eat_init(batch: int, device) -> EATState:
    return EATState(ema=ema_init(batch, device),
                    last=torch.zeros((batch,), dtype=torch.float32,
                                     device=device))


def _eat_update(state: EATState, x: torch.Tensor, alpha: float,
                active) -> EATState:
    ema = ema_update(state.ema, x, alpha, active)
    last = x if active is None else torch.where(active, x, state.last)
    return EATState(ema=ema, last=last)


@dataclasses.dataclass(frozen=True)
class EATStopper:
    """Alg. 1: stop when the de-biased EMA variance of EAT < delta."""

    alpha: float = 0.2
    delta: float = 1e-3

    def init(self, batch: int, device) -> EATState:
        return _eat_init(batch, device)

    def update(self, state: EATState, eat: torch.Tensor, active=None) -> EATState:
        return _eat_update(state, eat, self.alpha, active)

    def debiased_var(self, state: EATState) -> torch.Tensor:
        return ema_debiased_var(state.ema, self.alpha)

    def should_stop(self, state: EATState) -> torch.Tensor:
        return self.debiased_var(state) < self.delta


@dataclasses.dataclass(frozen=True)
class TokenBudgetStopper:
    """Alg. 2: stop at a fixed reasoning-token budget T (a natural
    ``</think>`` ends a row whatever the stopper)."""

    budget: int = 10_000

    def init(self, batch: int, device) -> torch.Tensor:
        return torch.zeros((batch,), dtype=torch.int32, device=device)

    def update(self, state: torch.Tensor, n_new_tokens: torch.Tensor,
               active=None) -> torch.Tensor:
        nxt = (state + n_new_tokens).to(torch.int32)
        return nxt if active is None else torch.where(active, nxt, state)

    def should_stop(self, state: torch.Tensor) -> torch.Tensor:
        return state >= self.budget


class UAState(NamedTuple):
    n_unique: torch.Tensor  # (B,) int32 last measured #UA@K


@dataclasses.dataclass(frozen=True)
class UniqueAnswerStopper:
    """Alg. 3: stop when #unique answers among K rollouts <= Delta."""

    k: int = 16
    max_unique: int = 1

    def init(self, batch: int, device) -> UAState:
        return UAState(n_unique=torch.full((batch,), 2**30, dtype=torch.int32,
                                           device=device))

    def update(self, state: UAState, answers: torch.Tensor, active=None) -> UAState:
        """answers: (B, K) integer canonical answer ids of K forced
        rollouts."""
        srt = torch.sort(answers, dim=-1).values
        uniq = (1 + (srt[:, 1:] != srt[:, :-1]).sum(-1)).to(torch.int32)
        if active is not None:
            uniq = torch.where(active, uniq, state.n_unique)
        return UAState(n_unique=uniq)

    def should_stop(self, state: UAState) -> torch.Tensor:
        return state.n_unique <= self.max_unique


@dataclasses.dataclass(frozen=True)
class ConfidenceStopper:
    """Yang et al. 2025b: confidence = exp(mean log p) over a greedy
    T'-token forced rollout (Eq. 16); stop when its EMA variance settles
    (the rule of Alg. 1, so Fig. 4 compares like with like)."""

    alpha: float = 0.2
    delta: float = 1e-4
    rollout_len: int = 5

    def init(self, batch: int, device) -> EATState:
        return _eat_init(batch, device)

    def update(self, state: EATState, confidence: torch.Tensor,
               active=None) -> EATState:
        return _eat_update(state, confidence, self.alpha, active)

    def should_stop(self, state: EATState) -> torch.Tensor:
        return ema_debiased_var(state.ema, self.alpha) < self.delta


class GiveUpState(NamedTuple):
    ema: EMAState
    best_var: torch.Tensor      # (B,) lowest de-biased variance so far
    stall_streak: torch.Tensor  # (B,) consecutive non-improving high-var evals


@dataclasses.dataclass(frozen=True)
class GiveUpStopper:
    """Give up on a question when progress stalls (the paper's §6
    'lower-threshold mechanism'): after ``patience`` consecutive
    evaluations whose de-biased variance is above ``ceiling`` and does not
    improve on the best so far by ``improve_tol`` (relative), once
    ``min_evals`` evaluations are in.  Composed with ``EATStopper``: exit =
    settled OR gave up."""

    alpha: float = 0.2
    ceiling: float = 0.05
    patience: int = 8
    min_evals: int = 6
    improve_tol: float = 0.05

    def init(self, batch: int, device) -> GiveUpState:
        return GiveUpState(
            ema=ema_init(batch, device),
            best_var=torch.full((batch,), torch.inf, dtype=torch.float32,
                                device=device),
            stall_streak=torch.zeros((batch,), dtype=torch.int32, device=device))

    def update(self, state: GiveUpState, eat: torch.Tensor,
               active=None) -> GiveUpState:
        ema = ema_update(state.ema, eat, self.alpha, active)
        var = ema_debiased_var(ema, self.alpha)
        improving = var < state.best_var * (1.0 - self.improve_tol)
        stalled = (var > self.ceiling) & ~improving & (ema.count >= self.min_evals)
        streak = torch.where(stalled, state.stall_streak + 1,
                             torch.zeros_like(state.stall_streak))
        best = torch.minimum(state.best_var, var)
        if active is not None:
            streak = torch.where(active, streak, state.stall_streak)
            best = torch.where(active, best, state.best_var)
        return GiveUpState(ema=ema, best_var=best, stall_streak=streak)

    def should_stop(self, state: GiveUpState) -> torch.Tensor:
        return state.stall_streak >= self.patience


def confidence_from_logprobs(logprobs: torch.Tensor, mask=None) -> torch.Tensor:
    """(B, T') per-token log p of a greedy rollout -> exp(mean), over the
    tokens ``mask`` keeps where it is given."""
    if mask is None:
        return torch.exp(logprobs.mean(-1))
    mask = mask.to(logprobs.dtype)
    s = (logprobs * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)
    return torch.exp(s)
