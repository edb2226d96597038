"""Black-box EAT monitoring with a proxy model (port of
``repro/serving/proxy.py``; paper §4.2, Fig. 5).

The reasoning model is a black box: only its emitted token stream is
visible.  A smaller local proxy model of the same tokenizer keeps its own
KV cache over that stream and computes EAT from its own next-token
distribution after a virtual ``</think>`` (+ prefix).

* ``ProxyMonitor`` — the standalone streaming monitor (one prefill + probe
  per arriving chunk, host loop).
* ``ProxyConfig`` + ``ProxyTier`` — the serving-stack integration: one
  ``ProxyTier`` per ``serve()`` run drives a ``ProxyExecutor`` (the shadow
  decode, its own cache and page pool) in lock-step with the generator's
  scheduler: prompt prefills at admission, page bookkeeping before each
  chunk, page frees at harvest.  ``ReasoningEngine(..., proxy=
  ProxyConfig(...))`` turns it on (``monitor_mode == "proxy"``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.eat import eval_eat
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.serving.cache import CacheConfig, alloc_cache, page_align
from repro_torch.serving.executor import (
    ProxyExecutor,
    ServeState,
    Snapshot,
    prompt_positions,
)
from repro_torch.serving.scheduler import PageAllocator


@dataclasses.dataclass
class ProxyMonitor:
    """Streaming EAT monitor around a proxy model.  ``consume``, ``probe``
    and ``prefill`` are its device operations (the reference builds them as
    jitted programs in ``build_stream_monitor_programs``)."""

    model: object
    monitor: ReasoningMonitor
    capacity: int = 2048

    def prefill(self, prompts, positions, pos1d, cache) -> torch.Tensor:
        return self.model.prefill(prompts, positions, pos1d, cache)

    def consume(self, cache, tokens, next_pos) -> torch.Tensor:
        """Prefill an arriving chunk (B, m) at next_pos..next_pos+m-1;
        returns the next position."""
        m = tokens.shape[1]
        pos1d = (next_pos[:, None]
                 + torch.arange(m, dtype=torch.int32, device=tokens.device)[None])
        self.model.prefill(tokens, pos1d, pos1d, cache)
        return next_pos + m

    def probe(self, cache, next_pos) -> torch.Tensor:
        return eval_eat(self.model, cache, self.monitor.probe, next_pos)

    def start(self, prompts, prompt_len) -> dict:
        """Feed the question prompt (left-padded).  Returns opaque state."""
        dev = self.model.device
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=dev)
        B, S = prompts.shape
        pos1d = prompt_positions(prompt_len, S, dev)
        cache = alloc_cache(self.model.cfg, B, self.capacity, device=dev)
        self.prefill(prompts, pos1d, pos1d, cache)
        return {
            "cache": cache,
            "next_pos": torch.as_tensor(np.asarray(prompt_len), dtype=torch.int32,
                                        device=dev),
            "monitor": self.monitor.init(B, dev),
            "probe_seconds": [],
        }

    def observe_chunk(self, state: dict, chunk, active=None, *,
                      next_pos=None) -> dict:
        """Consume a chunk of streamed reasoning tokens (B, c), PAD-right
        for finished sequences, and evaluate EAT.  ``next_pos`` (B,) is the
        authoritative stream offset from the generator's request state;
        without it the monitor falls back to its own counter, which is stale
        for a row re-seeded mid-stream (slot recycling).  CONSUMES
        ``state`` (its cache is updated in place);
        ``state['monitor'].stop_flag`` is the exit signal."""
        dev = self.model.device
        chunk = torch.as_tensor(np.asarray(chunk), dtype=torch.long, device=dev)
        B = chunk.shape[0]
        if active is None:
            active = torch.ones((B,), dtype=torch.bool, device=dev)
        base = (state["next_pos"] if next_pos is None
                else torch.as_tensor(next_pos, dtype=torch.int32, device=dev))
        t0 = time.perf_counter()
        new_pos = self.consume(state["cache"], chunk, base)
        eat = self.probe(state["cache"], new_pos)
        if eat.is_cuda:
            torch.cuda.synchronize(eat.device)
        dt = time.perf_counter() - t0
        due = torch.ones((B,), dtype=torch.bool, device=dev)  # chunk arrival
        mon = self.monitor.update(state["monitor"], eat, due, active)
        return {
            "cache": state["cache"],
            "next_pos": new_pos,
            "monitor": mon,
            "probe_seconds": state["probe_seconds"] + [dt],
            "last_eat": eat,
        }

    def should_stop(self, state: dict) -> torch.Tensor:
        return state["monitor"].stop_flag


# --------------------------------------------------------------------------
# Serving-stack integration: the proxy tier behind ``monitor_mode == "proxy"``
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ProxyConfig:
    """The proxy tier's recipe, handed to ``ReasoningEngine``.

    ``model`` is the monitor model (a ``models.model.Model`` holding its
    weights), typically much smaller than the generator.  ``cache`` /
    ``capacity`` default to the engine's own backend and logical capacity;
    override them to give the proxy its own page-pool budget."""

    model: object
    cache: Optional[CacheConfig] = None     # None -> inherit the engine's
    capacity: Optional[int] = None          # None -> EngineConfig.capacity


class ProxyTier:
    """One ``serve()`` run's host-side orchestration of the proxy tier.

    Owns the proxy's state (a ``ServeState`` driven only by
    ``ProxyExecutor``) and its page allocator, and exposes the hooks the
    engine's serve loop calls:

        start_batch     prefill the initial cohort's prompts
        begin_chunk     map pages the shadow decode may write, push the table
        observe         shadow one generator chunk -> (new_n, proxy monitor)
        free_row        return an exiting row's proxy pages (harvest)
        can_admit       proxy-pool admission gate (defer, don't refuse)
        check_capacity  proxy ring-wrap guard (refuse, like the scheduler's)
        admit           prefill + merge an admitted prompt into a proxy slot

    The tier never sees generator logits and never decides tokens: it
    consumes the emitted stream and returns exit decisions, which the
    engine applies through the generator executor's ``retract``.  It reads
    the proxy's state once per generator chunk (``snap``, the proxy's
    ``Snapshot``: its mirror of the proxy cache's ``cur`` and of the rows'
    emitted counts, updated for each admission)."""

    def __init__(self, executor: ProxyExecutor, ecfg, monitor: ReasoningMonitor,
                 cache_cfg: CacheConfig, capacity: int, budget: int):
        self.ex = executor
        self.ecfg = ecfg
        self.monitor = monitor
        self.ccfg = cache_cfg
        self.capacity = capacity
        self.budget = budget
        self.paged = cache_cfg.kind == "paged"
        self.probe_m = len(monitor.probe)
        self.state: ServeState | None = None
        self.snap: Snapshot | None = None
        self.alloc: PageAllocator | None = None
        self._C_pre: int | None = None

    # ------------------------------------------------------------ lifecycle
    def _fresh(self, prompts_np, plen_np, capacity: int, *,
               kept: bool = False) -> ServeState:
        """Prompt-prefilled proxy state, on the executor's kept cache (the
        one the shadow graphs capture) with ``kept``, else on a new one (an
        admission's or a paged prefill's).  Nothing is sampled: the proxy
        never chooses tokens, so ``rng`` / ``last_token`` / ``out_tokens``
        are inert; ``n_reasoning`` starts at 1 to mirror the generator's
        already-emitted first token."""
        ex = self.ex
        dev = ex.model.device
        prompts = torch.as_tensor(np.asarray(prompts_np), dtype=torch.long,
                                  device=dev)
        B, S = prompts.shape
        pos1d = prompt_positions(plen_np, S, dev)
        cache = (ex.cache_for(B, capacity) if kept
                 else alloc_cache(ex.cfg, B, capacity, device=dev))
        ex.prefill(prompts, pos1d, pos1d, cache)
        ones = torch.ones((B,), dtype=torch.long, device=dev)
        return ServeState(
            cache=cache,
            rng=None,
            active=torch.ones((B,), dtype=torch.bool, device=dev),
            next_pos=torch.as_tensor(np.asarray(plen_np), dtype=torch.int32,
                                     device=dev),
            last_token=torch.zeros((B,), dtype=torch.long, device=dev),
            n_reasoning=ones,
            monitor=self.monitor.init(B, dev),
            ended_think=torch.zeros((B,), dtype=torch.bool, device=dev),
            out_tokens=torch.full((B, 1), self.ecfg.pad_id, dtype=torch.long,
                                  device=dev),
            out_len=ones.clone(),
            steps=torch.zeros((), dtype=torch.long, device=dev),
        )

    def start_batch(self, prompts_np, plen_np, rows: list[int]) -> None:
        """Prefill the initial cohort (the rows the scheduler admitted)."""
        B, S = prompts_np.shape
        if not self.paged:
            self.state = self._fresh(prompts_np, plen_np, self.capacity,
                                     kept=True)
            self.snap = self.ex.snapshot(self.state)
            return
        ps = self.ccfg.page_size
        C_log = page_align(self.capacity, ps)
        n_blocks = C_log // ps
        num_pages = self.ccfg.num_pages or (B * n_blocks + 1)
        self.alloc = PageAllocator(num_pages, ps, n_blocks, B,
                                   sizing_knob="ProxyConfig.cache.num_pages")
        self._C_pre = page_align(S, ps)
        st = self._fresh(prompts_np, plen_np, self._C_pre)
        for row in rows:
            self.alloc.ensure(row, 0, S - 1)
        # page-native shadow decodes read through the proxy pool's own
        # compacted page list
        template = self.ex.paged_cache_for(
            B, C_log, ps, num_pages, alloc=self.alloc,
            native=self.ccfg.attn_impl != "gather")
        self.state = st._replace(cache=self.ex.pack_paged(
            template, st.cache, self.alloc.table))
        self.snap = self.ex.snapshot(self.state)

    # ------------------------------------------------------- chunk shadowing
    def begin_chunk(self, chunk: int, bound: list[int]) -> None:
        """Map (and push) pages covering the slots this chunk's shadow
        decode may write: up to ``chunk`` consumed tokens (clamped per row
        to its remaining budget) plus the probe tail, over the proxy's own
        pool and state."""
        if not self.paged:
            return
        self.state = self.ex.ensure_chunk_pages(
            self.alloc, self.state, bound, chunk + self.probe_m,
            tail=self.probe_m, budget=self.budget, cur=self.snap.cur,
            n_reasoning=self.snap.n_reasoning)

    def observe(self, gen_out_tokens, n_start, n_emitted, chunk: int, *,
                eager: bool = False):
        """Shadow one generator chunk (one graph replay on the card, unless
        ``eager``); returns ``(new_n, proxy monitor)`` (device tensors) for
        the generator executor's ``retract``.  ``n_start`` / ``n_emitted``
        are the per-row counts before the chunk and in it.  Reads the
        proxy's snapshot once."""
        self.state = self.ex.observe_chunk(self.state, gen_out_tokens,
                                           n_start, n_emitted, chunk,
                                           eager=eager)
        self.snap = self.ex.snapshot(self.state)
        return self.state.n_reasoning, self.state.monitor

    # ------------------------------------------------------ harvest / admit
    def free_row(self, slot: int) -> None:
        if self.paged:
            self.alloc.free_row(slot)

    def can_admit(self, prompt_tokens: int) -> bool:
        """Paged-pool admission gate: defers (stays queued), never raises."""
        return (not self.paged) or self.alloc.can_admit(prompt_tokens)

    def check_capacity(self, when: str) -> None:
        """Ring-wrap guard for an explicitly undersized proxy ring (the
        proxy's ``cur`` never outruns the generator's, so with inherited
        capacity the scheduler's own guard fires first)."""
        if self.paged:
            return
        used = self.snap.cur
        if used + self.budget > self.capacity:
            raise RuntimeError(
                f"proxy cache capacity {self.capacity} cannot hold {when}: "
                f"{used} slots committed + up to {self.budget} decode steps "
                f"would wrap the proxy ring. Raise ProxyConfig.capacity "
                f"(or leave it None to inherit EngineConfig.capacity).")

    def admit(self, slot: int, prompt_np, prompt_len: int, S: int) -> None:
        """Prefill + merge an admitted prompt into proxy ``slot``: the
        lock-step mirror of the generator's admission."""
        one = self._fresh(prompt_np[None], [prompt_len],
                          self._C_pre if self.paged else self.capacity)
        if self.paged:
            row_table = self.alloc.admit_row(slot, S, self.snap.cur)
            self.state = self.ex.admit_paged(self.state, one, slot, row_table)
        else:
            self.state = self.ex.admit(self.state, one, slot)
        self.snap.admit(slot, S)
