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
  ProxyConfig(...))`` turns it on (``monitor_mode == "proxy"``).  In the
  overlapped serve loop the tier's device work runs on a stream of its own
  (``ProxyTier.overlapped``), beside the generator's next chunk.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.eat import eval_eat
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.device import upload
from repro_torch.serving.cache import CacheConfig, alloc_cache, page_align
from repro_torch.serving.executor import (
    PendingSnapshot,
    ProxyExecutor,
    ServeState,
    Snapshot,
    _clone,
    _flat,
    positions_for,
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
        self.model.prefill(tokens, positions_for(self.model.cfg, pos1d), pos1d,
                           cache)
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
        self.prefill(prompts, positions_for(self.model.cfg, pos1d), pos1d, cache)
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
        shadow          the same in the overlapped loop (in ``overlapped``)
        free_row        return an exiting row's proxy pages (harvest)
        can_admit       proxy-pool admission gate (defer, don't refuse)
        check_capacity  proxy ring-wrap guard (refuse, like the scheduler's)
        admit           prefill + merge an admitted prompt into a proxy slot

    The tier never sees generator logits and never decides tokens: it
    consumes the emitted stream and returns exit decisions, which the
    engine applies through the generator executor's ``retract``.  It reads
    the proxy's state once per generator chunk (``snap``, the proxy's
    ``Snapshot``: its mirror of the proxy cache's ``cur`` and of the rows'
    emitted counts, updated for each admission).

    In the overlapped loop (``overlapped``, which holds the whole stream
    protocol) the tier's page pushes, shadow chunks (``shadow``) and
    admissions run on its own stream.  The proxy's mirror is exact at
    every boundary (the shadow's snapshot is read before the next push),
    so its page mapping needs no slack."""

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
        self.stream = None        # the tier's own stream (overlapped loop)

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
        prompts = upload(prompts_np, dev, torch.long)
        plen = upload(plen_np, dev, torch.int32)
        B, S = prompts.shape
        pos1d = prompt_positions(plen, S, dev)
        cache = (ex.cache_for(B, capacity) if kept
                 else alloc_cache(ex.cfg, B, capacity, device=dev))
        ex.prefill(prompts, positions_for(ex.cfg, pos1d), pos1d, cache)
        ones = torch.ones((B,), dtype=torch.long, device=dev)
        return ServeState(
            cache=cache,
            rng=None,
            active=torch.ones((B,), dtype=torch.bool, device=dev),
            next_pos=plen,
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

    # ---------------------------------------------------------------- stream
    @contextlib.contextmanager
    def overlapped(self):
        """The overlapped serve's stream protocol, all of it.  Inside, on
        the card, the tier's device work (page pushes, shadow chunks,
        admissions) runs on the proxy executor's side stream, beside the
        generator's chunks on the current stream, ordered both ways:

        * generator to tier: a shadow waits on the event recorded after the
          generator chunk's packed snapshot (``shadow``), the one generator
          tensor the tier reads, which nothing writes again;
        * tier to generator: the verdict ``shadow`` returns is a copy made
          on the side stream after the shadow, and the current stream waits
          for it.  The tier never writes that copy, so its later in-place
          writes to its own state (an admission's rows, a page push) cannot
          reach the generator's reads of the verdict, however late the
          generator's stream gets to them.

        Entering, the side stream waits for the work so far on the current
        stream (the setup's prefills); leaving, the current stream waits for
        the side stream (the next serve's work on the kept caches follows
        it).  On the CPU nothing changes."""
        if not self.state.active.is_cuda:
            yield
            return
        cur = torch.cuda.current_stream(self.state.active.device)
        self.stream = self.ex.side_stream()
        self.stream.wait_stream(cur)
        for t in _flat(self.state):
            t.record_stream(self.stream)
        try:
            yield
        finally:
            cur.wait_stream(self.stream)
            self.stream = None

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    # ------------------------------------------------------- chunk shadowing
    def begin_chunk(self, chunk: int, bound: list[int]) -> None:
        """Map (and push) pages covering the slots this chunk's shadow
        decode may write: up to ``chunk`` consumed tokens (clamped per row
        to its remaining budget) plus the probe tail, over the proxy's own
        pool and state."""
        if not self.paged:
            return
        with self._on_stream():
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

    def shadow(self, gen: PendingSnapshot, n_start, n_emitted, chunk: int,
               *, eager: bool = False):
        """``observe`` in the overlapped loop: shadow the generator chunk
        whose packed snapshot ``gen`` is (its tokens read on the device,
        after its event), then read the proxy's snapshot.  Returns the
        verdict ``(new_n, proxy monitor)`` for the generator executor's
        ``retract_lagged``: copies that the tier never writes, ordered
        before the current stream's next work (``overlapped``)."""
        with self._on_stream():
            if self.stream is not None:
                self.stream.wait_event(gen.event)
                gen.packed.record_stream(self.stream)
            self.state = self.ex.observe_chunk(self.state, gen.tokens,
                                               n_start, n_emitted, chunk,
                                               eager=eager)
            pending = self.ex.snapshot_async(self.state)
            new_n = self.state.n_reasoning.clone()
            mon = _clone(self.state.monitor)
        if self.stream is not None:
            cur = torch.cuda.current_stream(self.stream.device)
            cur.wait_stream(self.stream)
            for t in [new_n, *_flat(mon)]:
                t.record_stream(cur)
        self.snap = pending.wait()
        return new_n, mon

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
        with self._on_stream():
            one = self._fresh(prompt_np[None], [prompt_len],
                              self._C_pre if self.paged else self.capacity)
            if self.paged:
                row_table = self.alloc.admit_row(slot, S, self.snap.cur)
                self.state = self.ex.admit_paged(self.state, one, slot,
                                                 row_table)
            else:
                self.state = self.ex.admit(self.state, one, slot)
        self.snap.admit(slot, S)
