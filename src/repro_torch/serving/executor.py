"""Executor layer: the device work of the serving stack (port of
``repro/serving/executor.py``, self-EAT path).

The reference builds one jitted program per operation and donates the
decode state into it.  PyTorch runs eagerly, so each operation here is a
method that updates the state's cache in place, and the decode chunk is a
Python loop over the canonical EAT step (``make_eat_step``, non-fused: a
committed ``decode_step`` followed by a lazily gated, non-committing
``probe_entropy``).  A caller must treat a state it hands to a mutating
method (``decode_chunk``, ``admit``, ``admit_paged``) as consumed and go on
from the returned one.

  prefill        prompt -> cache fill (the cache it is given)
  decode_chunk   up to chunk_len monitored steps
  probe          non-committing EAT evaluation (the cache survives)
  admit          slot recycling row-merge (ring)
  admit_paged    row-merge through a page table
  pack_paged     dense prefill -> page pool
  rollout        forced answer generation; leaves the cache as it was
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.eat import eval_eat
from repro_torch.core.monitor import MonitorState, ReasoningMonitor
from repro_torch.models.transformer import preserved_slots, write_slots
from repro_torch.serving.cache import (
    blocks_arrays,
    freeze_inactive_rows,
    merge_cache_row,
    merge_paged_row,
    pack_paged_cache,
)
from repro_torch.serving.sampler import SamplerConfig, logprob_of, sample


class ServeState(NamedTuple):
    """Device-resident batched decode state (one row per slot)."""

    cache: dict
    rng: torch.Generator | None
    active: torch.Tensor        # (B,) bool still reasoning
    next_pos: torch.Tensor      # (B,) int32 next token position
    last_token: torch.Tensor    # (B,) int64
    n_reasoning: torch.Tensor   # (B,) int64 reasoning tokens generated
    monitor: MonitorState
    ended_think: torch.Tensor   # (B,) bool emitted </think> naturally
    out_tokens: torch.Tensor    # (B, T_buf) int64 generated reasoning tokens
    out_len: torch.Tensor       # (B,) int64


def make_eat_step(model, monitor: ReasoningMonitor | None,
                  sampler: SamplerConfig, *, window: int | None = None):
    """Build ``step(cache, token, pos1d, mon, active, rng)`` ->
    ``(next_token, mon, stop)``: one committed decode step, the sampler,
    then the monitor transition, whose probe runs only when an evaluation
    is due for some active row.  token/pos1d: (B, 1)."""
    cfg = model.cfg

    def step(cache, token, pos1d, mon: MonitorState, active, rng):
        logits = model.decode_step(token, pos1d, pos1d, cache, window=window)
        nxt = sample(logits[:, -1], cfg.vocab, sampler, rng)
        if monitor is None:
            return nxt, mon, torch.zeros_like(active)
        next_pos = pos1d[:, -1] + 1
        mon = monitor.observe(
            mon, lambda: eval_eat(model, cache, monitor.probe, next_pos),
            nxt, active)
        return nxt, mon, mon.stop_flag

    return step


def _put_row(big, small, slot: int) -> None:
    """Row ``slot`` of every tensor leaf of ``big`` <- row 0 of ``small``."""
    if isinstance(big, torch.Tensor):
        big[slot] = small[0]
        return
    for b, s in zip(big, small):
        _put_row(b, s, slot)


class Executor:
    """Every device operation ``ReasoningEngine`` drives."""

    def __init__(self, model, ecfg, monitor: ReasoningMonitor):
        self.model = model
        self.ecfg = ecfg
        self.monitor = monitor
        self.cfg = model.cfg
        self._recurrent = model.cfg.arch_type == "ssm"
        self._step_mon = make_eat_step(model, monitor, ecfg.sampler)
        self._step_plain = make_eat_step(model, None, ecfg.sampler)

    # ---------------------------------------------------------- decode
    def _advance(self, state: ServeState, budget: int, step_fn) -> ServeState:
        """One monitored decode step + engine bookkeeping, all masked."""
        ecfg = self.ecfg
        tok = state.last_token[:, None]
        # inactive rows still ride through the batched step, but their KV
        # write must be invisible: pos=-1 keeps it out of every later mask
        pos1d = torch.where(state.active, state.next_pos, -1)[:, None]
        # ... and an SSM state is rolled back to the entries before the step
        # (a commit replaces them, so these stay intact)
        before = list(state.cache["layers"]) if self._recurrent else None
        nxt, mon, stop = step_fn(state.cache, tok, pos1d, state.monitor,
                                 state.active, state.rng)
        if before is not None:
            freeze_inactive_rows(state.cache, before, state.active)
        nxt = torch.where(state.active, nxt, ecfg.pad_id)
        ended = state.ended_think | (state.active & (nxt == ecfg.end_think_id))
        rows = torch.arange(nxt.shape[0], device=nxt.device)
        state.out_tokens[rows, state.out_len] = nxt
        inc = state.active.long()
        n_reasoning = state.n_reasoning + inc
        over = n_reasoning >= budget
        return ServeState(
            cache=state.cache,
            rng=state.rng,
            active=state.active & ~stop & ~ended & ~over,
            next_pos=state.next_pos + inc.int(),
            last_token=nxt,
            n_reasoning=n_reasoning,
            monitor=mon,
            ended_think=ended,
            out_tokens=state.out_tokens,
            out_len=state.out_len + inc,
        )

    def decode_chunk(self, state: ServeState, budget: int, chunk_len: int, *,
                     use_monitor: bool = True) -> ServeState:
        """Advance up to ``chunk_len`` tokens, stopping early once no row is
        active.  CONSUMES ``state``."""
        step_fn = self._step_mon if use_monitor else self._step_plain
        for _ in range(chunk_len):
            if not bool(state.active.any()):
                break
            state = self._advance(state, budget, step_fn)
        return state

    # ---------------------------------------------------------- prefill/probe
    def prefill(self, tokens, positions, pos1d, cache) -> torch.Tensor:
        """Prompt prefill into ``cache`` (in place); returns hidden."""
        return self.model.prefill(tokens, positions, pos1d, cache)

    def probe(self, cache, next_pos) -> torch.Tensor:
        """Non-committing EAT probe over the live cache."""
        return eval_eat(self.model, cache, self.monitor.probe, next_pos)

    # ---------------------------------------------------------- admission
    def admit(self, state: ServeState, one: ServeState, slot: int) -> ServeState:
        """Recycle batch ``slot`` (ring cache) with the freshly prefilled
        single-sequence state ``one``.  CONSUMES ``state``."""
        merge_cache_row(state.cache, one.cache, slot)
        return self._put_state_row(state, one, slot)

    def admit_paged(self, state: ServeState, one: ServeState, slot: int,
                    row_table) -> ServeState:
        """Paged slot recycling: the prompt K/V go through ``row_table``
        (the allocator's fresh mapping for the slot).  CONSUMES ``state``."""
        merge_paged_row(state.cache, one.cache, slot, row_table)
        return self._put_state_row(state, one, slot)

    @staticmethod
    def _put_state_row(state: ServeState, one: ServeState, slot: int):
        for name in ("active", "next_pos", "last_token", "n_reasoning",
                     "monitor", "ended_think", "out_tokens", "out_len"):
            _put_row(getattr(state, name), getattr(one, name), slot)
        return state

    def pack_paged(self, paged_cache: dict, dense_cache: dict, table) -> dict:
        """Scatter a freshly prefilled dense cache into an empty paged one."""
        return pack_paged_cache(paged_cache, dense_cache, table)

    def put_page_table(self, state: ServeState, table,
                       blocks: tuple | None = None) -> ServeState:
        """Upload the host allocator's page table — and, in page-native
        mode, its compacted buckets ``(pages, logical, counts)``."""
        cache = state.cache
        dev = cache["pos"].device
        cache["page_table"] = torch.as_tensor(np.asarray(table, np.int32),
                                              device=dev)
        if blocks is not None:
            cache["blocks"] = blocks_arrays(*blocks, device=dev)
        return state

    def ensure_chunk_pages(self, alloc, state: ServeState, slots, span: int,
                           *, tail: int = 0, budget: int | None = None
                           ) -> ServeState:
        """Map (and push) pages covering the next ``span`` logical slots for
        every slot in ``slots`` before a writing operation.  With ``budget``
        the span is clamped per row to the tokens it can still emit plus
        the probe ``tail``.  The upload is skipped while the mapping is
        unchanged."""
        cur0 = int(state.cache["cur"])
        n_r = state.n_reasoning.cpu().numpy() if budget is not None else None
        for s in slots:
            sp = span
            if n_r is not None:
                sp = min(span, max(1, budget - int(n_r[s])) + tail)
            alloc.ensure(s, cur0, cur0 + sp)
        if not alloc.dirty:
            return state
        blocks = (alloc.block_buckets(alloc.bucket_width())
                  if "blocks" in state.cache else None)
        return self.put_page_table(state, alloc.snapshot(), blocks)

    # ---------------------------------------------------------- answers
    def rollout(self, cache, next_pos, rng, *, n: int, greedy: bool = False):
        """Forced answer rollout: append </think> then generate ``n``
        tokens.  Returns (tokens (B, n), logprobs (B, n)).  Positions,
        ``cur`` and the SSM states advance on a private copy (the layer list
        is copied; a commit replaces SSM entries, never writes them), and any
        live slot the rollout overwrites is restored: the cache is left as it
        was."""
        model, cfg, ecfg = self.model, self.cfg, self.ecfg
        B = next_pos.shape[0]
        local = dict(cache)
        local["pos"] = cache["pos"].clone()
        local["layers"] = list(cache["layers"])
        slots = write_slots(cache["cur"], n + 1, cache["pos"].shape[1],
                            next_pos.device)
        scfg = dataclasses.replace(ecfg.sampler, greedy=greedy)
        toks, lps = [], []
        with preserved_slots(cache, slots):
            et = torch.full((B, 1), ecfg.end_think_id, dtype=torch.long,
                            device=next_pos.device)
            pos1d = next_pos[:, None]
            logit = model.decode_step(et, pos1d, pos1d, local)[:, -1]
            pos = next_pos + 1
            for _ in range(n):
                tok = sample(logit, cfg.vocab, scfg, rng)
                toks.append(tok)
                lps.append(logprob_of(logit, tok, cfg.vocab))
                p1 = pos[:, None]
                logit = model.decode_step(tok[:, None], p1, p1, local)[:, -1]
                pos = pos + 1
        return torch.stack(toks, 1), torch.stack(lps, 1)
