"""Request layer: the per-request lifecycle state machine (copy of
``repro/serving/request.py``; pure host-side metadata, no torch).

Lifecycle::

    QUEUED --admit()--> PREFILLING --begin_decode()--> DECODING
                                                           |
                                     finish() --> EXITED (eat | end_think)
                                              \\-> EXHAUSTED (budget)

Transitions are enforced — a scheduler bug that double-admits a request or
harvests a queued one raises immediately instead of corrupting results.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    EXITED = "exited"          # EAT early exit or natural </think>
    EXHAUSTED = "exhausted"    # hit the reasoning-token budget


#: exit_reason values a finished request can carry
EXIT_EAT = "eat"               # EAT monitor latched stop (paper Alg. 1)
EXIT_END_THINK = "end_think"   # model emitted </think> on its own
EXIT_BUDGET = "budget"         # token budget exhausted

_TERMINAL = (RequestStatus.EXITED, RequestStatus.EXHAUSTED)


@dataclasses.dataclass
class Request:
    """One serving request and everything the host tracks about it."""

    rid: int
    prompt: "object"               # (S,) token ids (np array / list)
    prompt_len: int
    status: RequestStatus = RequestStatus.QUEUED
    slot: Optional[int] = None
    # chunk-boundary snapshots while DECODING: (n_reasoning, n_evals,
    # ema_var) triples — the request's EAT trajectory as the monitor saw it
    eat_trace: list = dataclasses.field(default_factory=list)
    exit_reason: Optional[str] = None
    result: Optional[dict] = None
    # wall-clock submission stamp (set by the serve loop's setup) — when
    # present, finish() derives result["latency_s"] from it
    submitted_at: Optional[float] = None

    # ------------------------------------------------------- transitions
    def _expect(self, *allowed: RequestStatus):
        if self.status not in allowed:
            raise RuntimeError(
                f"request {self.rid}: illegal transition from {self.status} "
                f"(expected one of {[a.value for a in allowed]})"
            )

    def admit(self, slot: int) -> None:
        """QUEUED -> PREFILLING: the scheduler granted batch ``slot``."""
        self._expect(RequestStatus.QUEUED)
        self.status = RequestStatus.PREFILLING
        self.slot = slot

    def begin_decode(self) -> None:
        """PREFILLING -> DECODING: the prefilled row is live in the batch."""
        self._expect(RequestStatus.PREFILLING)
        self.status = RequestStatus.DECODING

    def record_trace(self, n_reasoning: int, n_evals: int, ema_var: float) -> None:
        if self.status is RequestStatus.DECODING:
            self.eat_trace.append((int(n_reasoning), int(n_evals),
                                   float(ema_var)))

    def finish(self, *, reasoning_tokens, n_reasoning: int, ended_think: bool,
               eat_stop: bool, answer_tokens=None) -> None:
        """DECODING -> EXITED/EXHAUSTED with exit-reason metadata.

        Reason precedence mirrors the engine's exit latch: the EAT stop and
        the ``</think>`` check both beat the budget check (the budget only
        fires when neither latched in the same device step).
        """
        self._expect(RequestStatus.DECODING)
        if eat_stop:
            self.exit_reason = EXIT_EAT
        elif ended_think:
            self.exit_reason = EXIT_END_THINK
        else:
            self.exit_reason = EXIT_BUDGET
        self.status = (RequestStatus.EXHAUSTED
                       if self.exit_reason == EXIT_BUDGET
                       else RequestStatus.EXITED)
        self.result = {
            "request": self.rid,
            "reasoning_tokens": reasoning_tokens,
            "n_reasoning": int(n_reasoning),
            "ended_think": bool(ended_think),
            "exit_reason": self.exit_reason,
            "status": self.status.value,
            "slot": self.slot,
        }
        if answer_tokens is not None:
            self.result["answer_tokens"] = answer_tokens
        if self.submitted_at is not None:
            self.result["latency_s"] = time.perf_counter() - self.submitted_at
        self.slot = None

    # ----------------------------------------------------------- queries
    @property
    def done(self) -> bool:
        return self.status in _TERMINAL

    def to_result(self) -> dict:
        if self.result is None:
            raise RuntimeError(f"request {self.rid} never finished "
                               f"(status={self.status.value})")
        out = dict(self.result)
        out["eat_trace"] = list(self.eat_trace)
        return out
