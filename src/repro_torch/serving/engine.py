"""Reasoning-serving facade (port of ``repro/serving/engine.py``: the
self-EAT and proxy monitor modes, the synchronous and the overlapped serve
loops, and the evaluation path).

``ReasoningEngine`` drives the three layers: ``request`` (lifecycle),
``scheduler`` (slots, pages) and ``executor`` (device work).  ``serve``
runs continuous batching over a request queue: sequences that exit early
(EAT stop, natural ``</think>``, or budget) free their slot, the next
queued prompt is prefilled and merged into it, and decoding resumes with
the batch still full.  With ``EngineConfig.cache.kind == "paged"`` the KV
store is the block-paged pool and a request's pages return to the free
list the moment it exits; the token streams, exit steps and EAT traces are
bitwise those of the ring backend.  With ``proxy=ProxyConfig(...)`` a
second model shadows the emitted stream and supplies the exits (black-box
monitoring, ``serving/proxy.py``).  ``serve(overlap=True)`` runs the
overlapped loop of ``serving/pipeline.py`` instead: chunk N+1 goes out
before chunk N's snapshot is read.

The loop reads a chunk's outcome in one device-to-host copy
(``Executor.snapshot``); the host's ``Snapshot`` is also its mirror of
``cur`` and of the rows it admits between chunks, which the capacity checks
and the page mapping read.  On the card each decode chunk (each proxy
shadow chunk, and each forced-answer rollout) is one CUDA-graph replay;
``eager=True`` runs the guarded Python loop instead (the comparator of the
graph path).

The same machinery runs the paper's evaluation protocol (App. H):
``reason_with_trace`` generates one long chain and records, at every
evaluation point, EAT, the answers of K forced rollouts
(``rollout_answers``) and the confidence of a greedy rollout, which the
stopping rules of ``core/stopping.py`` are replayed over
(``benchmarks/torch_trace_harness.py``).  ``eval_eat_now``, the
unmonitored step ``_decode_fn`` and the per-token loop
``_reason_per_token`` are the costs and the baseline the chunked loop is
measured against.

An encoder-decoder (``arch_type="encdec"``) is served as the reference
serves it: ``start(prompts, prompt_len, frames=...)``, then ``reason()``,
``force_answer()`` and the evaluation path on the started state.  The
request queue (``serve``, either loop) and the proxy tier carry no frames
and refuse it (``refuse_encdec``).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core.eat import ProbeSpec
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper, confidence_from_logprobs
from repro_torch.device import upload
from repro_torch.serving.cache import CacheConfig, alloc_cache, page_align
from repro_torch.serving.executor import (
    Executor,
    ProxyExecutor,
    ServeState,
    positions_for,
    prompt_positions,
)
from repro_torch.serving.pipeline import serve_overlapped
from repro_torch.serving.proxy import ProxyConfig, ProxyTier
from repro_torch.serving.request import Request
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import (
    PageAllocator,
    SlotScheduler,
    admit_or_defer,
)


@dataclasses.dataclass
class EngineConfig:
    max_reasoning_tokens: int = 1024
    capacity: int = 2048                 # cache slots (logical, when paged)
    pad_id: int = 0
    end_think_id: int = 1
    newline_id: int = 2
    eos_id: int = 3
    chunk_len: int = 32                  # decode steps per host round trip
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)


def _view(model, ccfg: CacheConfig):
    """The engine's own view of ``model`` with the cache's decode-attention
    impl baked in (--attn-impl) and the ring comparator's block size pinned
    to the paged page size (the per-impl paged == ring contract).  The
    weights are shared, not copied."""
    model = copy.copy(model)
    model.paged_attn_impl = ccfg.attn_impl
    model.paged_attn_page = ccfg.page_size
    return model


def refuse_encdec(cfg, what: str) -> None:
    """Raise for an encoder-decoder ``cfg`` on an entry point that carries
    no frames (the request queue, the proxy tier)."""
    if cfg.arch_type == "encdec":
        raise ValueError(
            f"{what} carries no encoder frames: the encoder-decoder "
            f"{cfg.name} is served through ReasoningEngine.start(prompts, "
            f"prompt_len, frames=...), then reason() and force_answer(), as "
            f"in the reference")


class ReasoningEngine:
    """The serving facade, in one of two monitor modes:

    * ``self`` (default): white-box; the reasoning model is also the
      monitor model and the probe runs inline in the decode chunk.
    * ``proxy`` (``proxy=ProxyConfig(...)``): black-box; the generator
      decodes whole chunks with no inline probe (its model never runs
      ``probe_entropy``), and a second model shadows the emitted chunks
      through a ``ProxyExecutor``, supplying the exits through the
      executor's ``retract``.  A proxy running the generator's own weights
      reproduces self-EAT serving bit for bit under greedy sampling.
    """

    def __init__(self, model, ecfg: EngineConfig,
                 monitor: ReasoningMonitor | None = None,
                 proxy: ProxyConfig | None = None):
        model = _view(model, ecfg.cache)
        self.model = model
        self.device = model.device
        self.ecfg = ecfg
        if monitor is None:
            monitor = ReasoningMonitor(stopper=EATStopper(),
                                       probe=ProbeSpec((ecfg.end_think_id,)),
                                       newline_id=ecfg.newline_id)
        self.monitor = monitor
        self.executor = Executor(model, ecfg, monitor)
        self.proxy = proxy
        self.proxy_executor = None
        self._ptier = None       # the last serve's tier, for its pool stats
        if proxy is not None:
            refuse_encdec(model.cfg, "the proxy tier")
            refuse_encdec(proxy.model.cfg, "the proxy tier")
            if model.cfg.arch_type in ("ssm", "hybrid"):
                raise ValueError(
                    "monitor='proxy' needs a slot-addressed generator cache "
                    "to retract overshoot tokens; SSM/hybrid recurrences "
                    "cannot be rewound to the proxy's exit step.")
            self.proxy_executor = ProxyExecutor(
                _view(proxy.model, proxy.cache or ecfg.cache), ecfg, monitor)

    @property
    def monitor_mode(self) -> str:
        return "proxy" if self.proxy is not None else "self"

    # ------------------------------------------------------------- prefill
    def start(self, prompts, prompt_len, rng: torch.Generator | None = None,
              *, frames=None, image_embeds=None, capacity: int | None = None,
              fresh: bool = False) -> ServeState:
        """prompts: (B, S) LEFT-padded token ids; prompt_len: (B,); an
        encoder-decoder also takes ``frames`` (B, T, d_model), the stub
        frontend's embeddings, which are encoded into the cache's cross K/V.
        Positions are 0..len-1 per sequence (pad slots get -1 = masked).
        A VLM may take ``image_embeds`` (B, P, d_model), the stub vision
        tower's patches: the stream is [patches | pads | text], the patches
        at positions 0..P-1, the text shifted by P, the pads -1 (M-RoPE's
        three streams all equal, as in the reference), and the next
        position P + prompt_len; the capacity must hold P + S slots.
        The cache is the executor's kept one of (B, capacity), which the
        chunk graphs capture (an earlier state on it is consumed); with
        ``fresh`` a new one (an admission's or a paged prefill's, merged
        into the serving cache and dropped)."""
        model, ecfg, dev = self.model, self.ecfg, self.device
        prompts = upload(prompts, dev, torch.long)
        plen = upload(prompt_len, dev, torch.int32)
        B, S = prompts.shape
        pos1d = prompt_positions(plen, S, dev)
        n_img = 0
        if image_embeds is not None:
            if model.cfg.arch_type != "vlm":
                raise ValueError(f"{model.cfg.name} is not a VLM: it takes no "
                                 f"image_embeds")
            image_embeds = upload(image_embeds, dev)
            n_img = image_embeds.shape[1]
            img_pos = torch.arange(n_img, dtype=torch.int32, device=dev).expand(B, n_img)
            pos1d = torch.cat([img_pos, torch.where(pos1d >= 0, pos1d + n_img, -1)], 1)
        capacity = capacity or ecfg.capacity
        if capacity < n_img + S:
            raise ValueError(f"capacity {capacity} cannot hold {n_img} image "
                             f"patches and {S} prompt slots")
        cache = (alloc_cache(model.cfg, B, capacity, device=dev) if fresh
                 else self.executor.cache_for(B, capacity))
        if frames is not None:
            frames = upload(frames, dev)
        self.executor.settle_rng()
        hidden = self.executor.prefill(prompts, positions_for(model.cfg, pos1d),
                                       pos1d, cache, frames=frames,
                                       image_embeds=image_embeds)
        logits_last = model.logits(hidden[:, -1:])[:, 0]
        first = sample(logits_last, model.cfg.vocab, ecfg.sampler, rng)
        buf = torch.full((B, ecfg.max_reasoning_tokens + 8), ecfg.pad_id,
                         dtype=torch.long, device=dev)
        buf[:, 0] = first
        return ServeState(
            cache=cache,
            rng=rng,
            active=torch.ones((B,), dtype=torch.bool, device=dev),
            next_pos=plen + n_img,
            last_token=first,
            n_reasoning=torch.ones((B,), dtype=torch.long, device=dev),
            monitor=self.monitor.init(B, dev),
            ended_think=first == ecfg.end_think_id,
            out_tokens=buf,
            out_len=torch.ones((B,), dtype=torch.long, device=dev),
            steps=torch.zeros((), dtype=torch.long, device=dev),
        )

    # ------------------------------------------------------------- loop
    def reason(self, state: ServeState, *, max_tokens: int | None = None,
               use_monitor: bool = True, chunk_len: int | None = None,
               eager: bool = False) -> ServeState:
        """Run the reasoning loop until every sequence exits (``eager``: as
        in ``serve``).  CONSUMES ``state``."""
        if use_monitor and self.proxy is not None:
            raise ValueError(
                "monitor='proxy' runs through serve() (the proxy tier must "
                "prefill the prompts the scheduler admits; a bare ServeState "
                "does not carry them); use serve(), or pass use_monitor=False "
                "for an unmonitored reason().")
        budget = int(max_tokens or self.ecfg.max_reasoning_tokens)
        chunk = max(1, chunk_len or self.ecfg.chunk_len)
        while True:
            state = self.executor.decode_chunk(state, budget, chunk,
                                               use_monitor=use_monitor,
                                               eager=eager)
            if not self.executor.snapshot(state).active.any():
                return state

    def _serve_setup(self, prompts, prompt_len, rng, *, batch_size: int,
                     max_tokens: int | None, chunk_len: int | None,
                     use_monitor: bool = True,
                     overlap: bool = False) -> SimpleNamespace:
        """Parse the request list, build the scheduler / page allocator /
        proxy tier, prefill + pack the initial cohort, run the setup-time
        capacity checks.  ``overlap`` grows the auto-sized page pool by one
        row's pages: the overlapped loop parks a harvested row's pages on
        the chunk in flight for one boundary, so a slot's old and new
        occupant briefly hold pages together."""
        prompts_np = np.asarray(prompts)
        plen_np = np.asarray(prompt_len)
        n_req, S = prompts_np.shape
        B = min(batch_size, n_req)
        budget = int(max_tokens or self.ecfg.max_reasoning_tokens)
        chunk = max(1, chunk_len or self.ecfg.chunk_len)
        t0 = time.perf_counter()
        requests = [Request(rid=i, prompt=prompts_np[i],
                            prompt_len=int(plen_np[i]), submitted_at=t0)
                    for i in range(n_req)]
        sched = SlotScheduler(requests, B, capacity=self.ecfg.capacity,
                              budget=budget)
        ccfg = self.ecfg.cache
        paged = ccfg.kind == "paged"
        alloc = C_pre = None
        if paged:
            ps = ccfg.page_size
            C_log = page_align(self.ecfg.capacity, ps)
            n_blocks = C_log // ps
            num_pages = ccfg.num_pages or (
                B * n_blocks + 1 + (n_blocks if overlap else 0))
            alloc = PageAllocator(num_pages, ps, n_blocks, B)
            C_pre = page_align(S, ps)      # prompt-sized prefill capacity

        # the proxy tier: the generator chunk runs with its inline monitor
        # OFF (the black-box contract) and the proxy shadows each chunk,
        # feeding exits back through retract
        proxy_mode = use_monitor and self.proxy is not None
        ptier = self._ptier = None
        if proxy_mode:
            ptier = self._ptier = ProxyTier(
                self.proxy_executor, self.ecfg, self.monitor,
                self.proxy.cache or ccfg,
                self.proxy.capacity or self.ecfg.capacity, budget)

        cohort = sched.start_batch()
        state = self.start(prompts_np[:B], plen_np[:B], rng,
                           capacity=C_pre if paged else None, fresh=paged)
        if paged:
            for req in cohort:
                alloc.ensure(req.slot, 0, S - 1)       # the prompt pages
            template = self.executor.paged_cache_for(
                B, C_log, ps, num_pages, alloc=alloc,
                native=ccfg.attn_impl != "gather")
            state = state._replace(cache=self.executor.pack_paged(
                template, state.cache, alloc.table))
        if ptier is not None:
            ptier.start_batch(prompts_np[:B], plen_np[:B],
                              [req.slot for req in cohort])
        for req in cohort:
            req.begin_decode()
        snap = self.executor.snapshot(state)
        sched.check_capacity(snap.cur, "the initial batch")
        if ptier is not None:
            ptier.check_capacity("the initial batch")
        return SimpleNamespace(
            requests=requests, sched=sched, state=state, snap=snap, alloc=alloc,
            paged=paged, S=S, B=B, budget=budget, chunk=chunk, C_pre=C_pre,
            rng=rng,
            ptier=ptier, gen_monitor=use_monitor and not proxy_mode,
            # the generator pays a probe tail only when IT probes; in proxy
            # mode that tail belongs to the proxy tier's pool
            tail=0 if proxy_mode else len(self.monitor.probe))

    def serve(self, prompts, prompt_len, rng: torch.Generator | None = None, *,
              batch_size: int, max_tokens: int | None = None,
              use_monitor: bool = True, chunk_len: int | None = None,
              answer_len: int = 0, record_trace: bool = False,
              eager: bool = False, overlap: bool = False,
              pipeline_hooks=None) -> list[dict]:
        """Continuous-batching serving loop over N requests with
        ``batch_size`` slots (synchronous chunk boundaries, unless
        ``overlap``).

        prompts: (N, S) LEFT-padded; prompt_len: (N,).  Returns one dict per
        request, in request order: ``reasoning_tokens``, ``n_reasoning``,
        ``ended_think``, ``exit_reason`` (eat / end_think / budget),
        ``status``, ``slot`` (the batch slot it ran in), ``latency_s``,
        ``eat_trace`` (chunk-boundary
        ``(n_reasoning, n_evals, ema_var)`` with ``record_trace``) and, when
        ``answer_len`` > 0, the greedy forced-answer ``answer_tokens``.

        In proxy mode the generator chunk decodes unmonitored, the proxy
        tier shadows the emitted tokens (its own prefills and pages in
        lock-step with the scheduler) and ``Executor.retract`` reconciles
        each chunk, so harvest, traces and exit reasons read as in self-EAT
        serving.  Admissions gate on both page pools
        (``scheduler.admit_or_defer``).

        The loop reads the device once per chunk (``Executor.snapshot``,
        after the proxy's retract in proxy mode); between chunks it works
        from that ``Snapshot``, updated for each admission.  On the card a
        chunk is one CUDA-graph replay (captured at the first chunk of its
        key; the executors keep their caches, so a later serve of this
        engine replays without capturing); ``eager=True`` runs every chunk
        as the guarded Python loop, with the same results under greedy
        sampling.

        With ``overlap`` the loop is the one-deep pipeline of
        ``serving/pipeline.py`` (the reference's ``--overlap on``): chunk
        N+1 is dispatched before chunk N's snapshot is read, harvests,
        admissions and page pushes run while it flies, and in proxy mode
        the shadow of chunk N runs on the tier's own stream beside it and
        its verdict lands one boundary late (``Executor.retract_lagged``).
        Under greedy sampling the tokens, exits, slots and answers are the
        sync loop's, and the EAT traces too unless the loop admits a
        request behind a chunk that moved the ring by other than a whole
        number of pages (its block sums then round differently); a sampled
        replay moves the generator by all its draws
        (``Executor.decode_chunk_snapshot``), so sampled streams differ.
        ``pipeline_hooks`` (a ``serving.pipeline.PipelineHooks``) sees every
        pipeline event (the tests' seam).  The engine's ``capacity`` needs
        one chunk of headroom (the ring guard adds the chunk in flight).
        """
        refuse_encdec(self.model.cfg, "serve() (the request queue, either loop)")
        ss = self._serve_setup(prompts, prompt_len, rng, batch_size=batch_size,
                               max_tokens=max_tokens, use_monitor=use_monitor,
                               chunk_len=chunk_len, overlap=overlap)
        if overlap:
            try:
                return serve_overlapped(self, ss, answer_len=answer_len,
                                        record_trace=record_trace, eager=eager,
                                        hooks=pipeline_hooks)
            finally:
                if ss.ptier is not None:
                    ss.ptier.state = None
        sched, state, alloc, paged = ss.sched, ss.state, ss.alloc, ss.paged
        S, budget, chunk, C_pre = ss.S, ss.budget, ss.chunk, ss.C_pre
        tail, ptier, snap = ss.tail, ss.ptier, ss.snap

        def ensure_pages(span: int, *, clamp_to_budget: bool = False):
            return self.executor.ensure_chunk_pages(
                alloc, state, [s for s, _ in sched.bound()], span, tail=tail,
                budget=budget if clamp_to_budget else None, cur=snap.cur,
                n_reasoning=snap.n_reasoning)

        while sched.running:
            if snap.active.any():
                if paged:
                    # a chunk writes <= chunk decode tokens (fewer near the
                    # budget), each probe another len(probe) slots past them
                    state = ensure_pages(chunk + tail, clamp_to_budget=True)
                # the per-row counts before the chunk, on the device
                n_start = state.out_len.clone() if ptier is not None else None
                state = self.executor.decode_chunk(state, budget, chunk,
                                                   use_monitor=ss.gen_monitor,
                                                   eager=eager)
                if ptier is not None:
                    # shadow the chunk through the proxy, then rewind
                    # overshoot rows to its exit step and install its monitor
                    ptier.begin_chunk(chunk, [s for s, _ in sched.bound()])
                    new_n, pmon = ptier.observe(state.out_tokens, n_start,
                                                state.out_len - n_start, chunk,
                                                eager=eager)
                    state = self.executor.retract(state, new_n, pmon)
                snap = self.executor.snapshot(state)
            if record_trace:
                for s, req in sched.bound():
                    req.record_trace(snap.n_reasoning[s], snap.n_evals[s],
                                     snap.var[s])
            done = sched.finished_slots(snap.active)
            if not done:
                continue
            # harvest (answers roll out from the still-intact cache rows)
            # BEFORE any slot is overwritten by an admission
            ans = None
            if answer_len:
                if paged:
                    # a rollout writes </think> + answer_len slots past cur
                    state = ensure_pages(answer_len + 1)
                toks, _ = self.force_answer(state, answer_len, greedy=True,
                                            eager=eager)
                ans = toks.cpu().numpy()
            for s, req in done:
                sched.release(s)
                req.finish(
                    reasoning_tokens=snap.tokens[s, :snap.out_len[s]].copy(),
                    n_reasoning=int(snap.n_reasoning[s]),
                    ended_think=bool(snap.ended_think[s]),
                    eat_stop=bool(snap.stop_flag[s]),
                    answer_tokens=ans[s].copy() if ans is not None else None,
                )
                if paged:
                    alloc.free_row(s)
                if ptier is not None:
                    # a proxy-driven exit frees BOTH pools
                    ptier.free_row(s)
            # admission sweeps EVERY free slot: a paged admission deferred
            # earlier (pool momentarily full) left its slot empty, and the
            # pages freed just above are what let it proceed now
            for s in (s for s, r in enumerate(sched.slots) if r is None):
                if sched.pending == 0:
                    continue
                sched.check_capacity(snap.cur, "another admission")
                if ptier is not None:
                    ptier.check_capacity("another admission")
                # every pool must cover the prompt (all-or-nothing): the
                # request stays queued until a harvest frees pages in
                # whichever pool is short
                if not admit_or_defer(S, alloc,
                                      ptier.alloc if ptier is not None else None):
                    continue
                nxt = sched.admit_next(s)
                one = self.start(nxt.prompt[None], [nxt.prompt_len], rng,
                                 capacity=C_pre if paged else None, fresh=True)
                if paged:
                    row_table = alloc.admit_row(s, S, snap.cur)
                    state = self.executor.admit_paged(state, one, s, row_table)
                else:
                    state = self.executor.admit(state, one, s)
                snap.admit(s, S)
                if ptier is not None:
                    ptier.admit(s, nxt.prompt, nxt.prompt_len, S)
                nxt.begin_decode()
            if sched.pending and not sched.running:
                # every slot is empty yet the queue cannot drain: name the
                # pool that is too small to hold one request
                if paged and not alloc.can_admit(S):
                    raise RuntimeError(
                        f"paged KV cache cannot hold a single request: "
                        f"{alloc.free_pages} pages free with every slot empty, "
                        f"but a prompt needs {alloc.blocks_for(S) + 1} pages. "
                        f"Raise CacheConfig.num_pages.")
                if ptier is not None and not ptier.can_admit(S):
                    raise RuntimeError(
                        f"proxy paged KV cache cannot hold a single request: "
                        f"{ptier.alloc.free_pages} pages free with every slot "
                        f"empty, but a prompt needs "
                        f"{ptier.alloc.blocks_for(S) + 1} pages. "
                        f"Raise ProxyConfig.cache.num_pages.")
        if ptier is not None:
            # drop the tier's device state (its cache is its largest
            # allocation); the allocator's stats stay readable via _ptier
            ptier.state = None
        return [r.to_result() for r in ss.requests]

    # ------------------------------------------------------------- answers
    def force_answer(self, state: ServeState, n_tokens: int, rng=None, *,
                     greedy: bool = False, eager: bool = False):
        """GenTillEoS(Q, <think>, R, </think>) — Eq. (10)/Alg. 1 line 11.
        Returns (tokens (B, n), logprobs (B, n)); the cache is untouched.
        On the card one graph replay (``Executor.rollout``), unless
        ``eager``."""
        rng = rng if rng is not None else state.rng
        return self.executor.rollout(state.cache, state.next_pos, rng,
                                     n=n_tokens, greedy=greedy, eager=eager)

    def rollout_answers(self, state: ServeState, k: int, n_tokens: int, rng,
                        *, eager: bool = False) -> torch.Tensor:
        """K independent sampled forced rollouts (for Pass@1 / #UA@K):
        tokens (K, B, n).  The K rollouts draw in turn from the one
        generator ``rng``, which stands for the reference's
        ``jax.random.split(rng, k)``: each rollout's draws follow the
        previous one's in its stream."""
        return torch.stack([self.force_answer(state, n_tokens, rng,
                                              eager=eager)[0]
                            for _ in range(k)])

    def eval_eat_now(self, state: ServeState) -> torch.Tensor:
        """EAT of every row at its current position (a non-committing probe
        over the live cache): (B,) float32."""
        return self.executor.probe(state.cache, state.next_pos)

    # ------------------------------------------------------------- baselines
    @property
    def _decode_fn(self):
        """One unmonitored decode step, ``state -> state`` (CONSUMES it)."""
        return self.executor.decode_step

    def _reason_per_token(self, state: ServeState, *,
                          max_tokens: int | None = None,
                          use_monitor: bool = True) -> ServeState:
        """The pre-chunking host loop, kept as the baseline the chunked loop
        is raced against: one eager decode step per token, two host reads
        per step (and the probe's when an evaluation is due).  CONSUMES
        ``state``."""
        budget = max_tokens or self.ecfg.max_reasoning_tokens
        while bool(state.active.any()) and int(state.n_reasoning.max()) < budget:
            state = self.executor.decode_step(state)
            if use_monitor:
                due = self.monitor.due(state.monitor, state.last_token)
                if bool((due & state.active).any()):
                    eat = self.executor.probe(state.cache, state.next_pos)
                    mon = self.monitor.update(state.monitor, eat, due,
                                              state.active)
                else:
                    mon = self.monitor.tick_no_eval(state.monitor, state.active)
                state = state._replace(monitor=mon)
                exits = mon.stop_flag
            else:
                exits = torch.zeros_like(state.active)
            over = state.n_reasoning >= budget
            state = state._replace(
                active=state.active & ~exits & ~state.ended_think & ~over)
        return state

    # ------------------------------------------------------------- tracing
    def reason_with_trace(self, state: ServeState, *, max_tokens: int,
                          rollout_k: int = 0, rollout_len: int = 8,
                          answer_extract=None, confidence_len: int = 0,
                          rollout_rng: torch.Generator | None = None,
                          eager: bool = False) -> tuple[ServeState, list[dict]]:
        """Generate one long chain and record, at every evaluation point,
        EAT (and optionally K rollout answers and the confidence): the
        offline evaluation protocol of App. H.  No early exit is taken.

        The chain runs as unmonitored ``decode_chunk``s of ``every_n``
        tokens (1 under the newline schedule, where a due point can fall on
        any token): graph replays on the card unless ``eager``.  After each
        chunk one ``Executor.snapshot`` gives the host the rows that emitted
        a token and their last token; a row is due where it emitted (the
        budget-th token's point included) and, under the newline schedule,
        its last token is the newline.  A record holds ``n_tokens``,
        ``due``, ``eat``, with ``rollout_k`` the ``rollouts`` (K, B, n) and
        (with ``answer_extract``) their ``answers`` (K, B), with
        ``confidence_len`` the ``confidence`` of a greedy rollout
        (``confidence_from_logprobs``), and the monitor's debiased
        ``ema_var`` after the update.  The rollouts draw from
        ``rollout_rng``, by default a copy of the state's generator taken
        at the start, so the chain's tokens do not depend on ``rollout_k``.
        CONSUMES ``state``."""
        ex, mon = self.executor, self.monitor
        ex.settle_rng()
        if rollout_rng is None:
            rollout_rng = _fork(state.rng, self.device)
        newline = mon.schedule == "newline"
        chunk = 1 if newline else mon.every_n
        trace: list[dict] = []
        snap = ex.snapshot(state)
        while snap.active.any():
            prev_n = snap.n_reasoning
            state = ex.decode_chunk(state, max_tokens, chunk, use_monitor=False,
                                    eager=eager)
            snap = ex.snapshot(state)
            emitted = snap.n_reasoning > prev_n
            due = emitted.copy()
            if newline:
                last = snap.tokens[np.arange(len(due)), snap.out_len - 1]
                due &= last == mon.newline_id
            if not due.any():
                continue
            eat = self.eval_eat_now(state)
            rec: dict = {"n_tokens": snap.n_reasoning, "due": due,
                         "eat": eat.cpu().numpy()}
            if rollout_k:
                rolls = self.rollout_answers(state, rollout_k, rollout_len,
                                             rollout_rng, eager=eager)
                rec["rollouts"] = rolls.cpu().numpy()
                if answer_extract is not None:
                    rec["answers"] = np.stack([answer_extract(r)
                                               for r in rec["rollouts"]])
            if confidence_len:
                _, lps = self.force_answer(state, confidence_len, greedy=True,
                                           eager=eager)
                rec["confidence"] = confidence_from_logprobs(lps).cpu().numpy()
            ms = mon.update(state.monitor, eat,
                            torch.as_tensor(due, device=self.device),
                            torch.as_tensor(emitted, device=self.device))
            state = state._replace(monitor=ms)
            rec["ema_var"] = mon.stopper.debiased_var(ms.stop_state).cpu().numpy()
            trace.append(rec)
        return state, trace


def _fork(rng: torch.Generator | None, device) -> torch.Generator:
    """A new generator at ``rng``'s state (the device's default generator
    where it is None)."""
    dev = torch.device(device)
    src = rng
    if src is None:
        src = (torch.cuda.default_generators[dev.index or 0]
               if dev.type == "cuda" else torch.default_generator)
    out = torch.Generator(device=dev)
    out.set_state(src.get_state())
    return out
