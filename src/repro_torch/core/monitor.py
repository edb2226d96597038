"""Reasoning-stream monitor: evaluation scheduling + stopper wiring (port of
``repro/core/monitor.py``).

All state is tensors and every decision a mask.  The lazy probe in
``observe`` is the reference's ``lax.cond``: ``device_if`` on ``(due &
active).any()`` (``serving/device_loop.py``), so steps with no evaluation
due pay no probe forward.  ``lazy=False`` probes every step (the chunk
graphs' step): ``update`` with ``use`` all false is ``tick_no_eval``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, NamedTuple

import torch

from repro_torch.core.eat import ProbeSpec
from repro_torch.core.stopping import EATState, EATStopper
from repro_torch.serving.device_loop import device_if


class MonitorState(NamedTuple):
    stop_state: EATState
    since_eval: torch.Tensor   # (B,) tokens since last evaluation
    n_evals: torch.Tensor      # (B,) evaluations so far
    stop_flag: torch.Tensor    # (B,) bool latched exit decision


@dataclasses.dataclass(frozen=True)
class ReasoningMonitor:
    stopper: EATStopper
    probe: ProbeSpec
    schedule: Literal["newline", "every_n"] = "newline"
    newline_id: int = -1              # token id of "\n\n" (schedule=newline)
    every_n: int = 100                # schedule=every_n
    min_evals: int = 2                # don't stop before this many evals

    def init(self, batch: int, device) -> MonitorState:
        return MonitorState(
            stop_state=self.stopper.init(batch, device),
            since_eval=torch.zeros((batch,), dtype=torch.int32, device=device),
            n_evals=torch.zeros((batch,), dtype=torch.int32, device=device),
            stop_flag=torch.zeros((batch,), dtype=torch.bool, device=device),
        )

    def due(self, state: MonitorState, new_token: torch.Tensor) -> torch.Tensor:
        """(B,) — which sequences need an EAT evaluation after this token."""
        if self.schedule == "newline":
            return new_token == self.newline_id
        return (state.since_eval + 1) >= self.every_n

    def update(self, state: MonitorState, eat, due, active) -> MonitorState:
        use = due & active
        stop_state = self.stopper.update(state.stop_state, eat, active=use)
        n_evals = state.n_evals + use.to(torch.int32)
        since = torch.where(use, torch.zeros_like(state.since_eval),
                            state.since_eval + active.to(torch.int32))
        should = self.stopper.should_stop(stop_state) & (n_evals >= self.min_evals)
        stop_flag = state.stop_flag | (should & active)
        return MonitorState(stop_state, since, n_evals, stop_flag)

    def tick_no_eval(self, state: MonitorState, active) -> MonitorState:
        return state._replace(
            since_eval=state.since_eval + active.to(torch.int32))

    def observe(self, state: MonitorState, eat_fn, new_token, active, *,
                lazy: bool = True) -> MonitorState:
        """One decode step's monitor transition.  ``eat_fn() -> (B,)`` is
        the probe forward; with ``lazy`` it runs only when some active
        sequence hits an evaluation point."""
        due = self.due(state, new_token)
        if not lazy:
            return self.update(state, eat_fn(), due, active)
        return device_if((due & active).any(),
                         lambda: self.update(state, eat_fn(), due, active),
                         lambda: self.tick_no_eval(state, active))
