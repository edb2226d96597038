"""Overlapped (double-buffered) serve loop: the host layer between
scheduler and executor (port of ``repro/serving/pipeline.py``).

The synchronous loop in ``engine.serve`` pays one host round trip per
chunk boundary: dispatch chunk N, wait for its snapshot, harvest, admit,
push page tables, dispatch chunk N+1, while the card idles.  This module
runs a one-deep software pipeline instead:

    tick t:   dispatch chunk F        (the snapshot is on its way: a
                                       pinned copy and an event behind
                                       the chunk, not a value)
              process boundary F-1    (waits on F-1's event only; F
                                       keeps running)

``Executor.decode_chunk_snapshot`` enqueues each chunk's packed snapshot
right behind it on the stream, which is what lets chunk F be dispatched
before anything of F-1 has been read.  Harvests, forced answers,
admissions, page-table pushes and, in proxy mode, the shadow of chunk F-1
happen while chunk F flies.  In proxy mode the tier's work runs on a
stream of its own beside the generator's (``ProxyTier.overlapped`` holds
that protocol), and the proxy's verdict is applied one boundary late
(``Executor.retract_lagged``): at most one chunk of exit latency, no token
changed (greedy streams are the sync loop's bitwise).  Every upload goes
through pinned memory without blocking the host (``device.upload``), and
the forced answers of a harvest reach their requests at the next
boundary's wait, or at the drain: the host never waits on a chunk in
flight.

Host-side consistency is the job of two pieces of host bookkeeping:

* ``scheduler.InFlightLedger`` — dispatch fences.  A harvested row's KV
  pages stay OUT of the allocator free list until the fence open at
  harvest time retires (the chunk in flight still maps them); a slot
  re-admitted while chunk F is in flight is skipped in chunk F's snapshot
  (its row there belongs to the previous occupant).
* host **mirrors** of the ring pointer and the per-row token counts
  (``mirror_cur``, ``mirror_nr``, ``mirror_outlen``), updated from each
  retired snapshot and set for each admission; nothing reads a snapshot's
  row of an admitted slot (``Snapshot.admit``'s stale fields are never
  used here).  They lag the device by at most one dispatched chunk, so
  page mapping passes ``slack = chunk`` (``Executor.ensure_chunk_pages``)
  and the ring guard checks ``mirror_cur + chunk``: admission under
  overlap wants one chunk of capacity headroom.

A chunk whose rows are all inactive is still a full replay of its masked
steps on the card (the reference's ``while_loop`` runs zero steps); its
snapshot shows ``steps == 0`` and ``stats["idle_chunks"]`` counts it.  The
proxy's shadow of such a chunk would be an identity and is skipped
(``stats["shadows_skipped"]``).
"""
from __future__ import annotations

import contextlib

from repro_torch.serving.executor import ToHost
from repro_torch.serving.scheduler import InFlightLedger, admit_or_defer


class PipelineHooks:
    """Observation/interference seam for the overlapped loop.

    Every pipeline event calls the matching no-op method below; tests
    subclass to (a) record the event order — asserting, e.g., that chunk
    F+1's dispatch precedes boundary F's harvest — and (b) FORCE
    adversarial schedules: a hook that waits on the snapshot inside
    ``on_dispatch`` degenerates the pipeline to harvest-before-dispatch,
    pinning that correctness never depends on the overlap actually
    overlapping.  Hooks run on the host thread; raising aborts the serve.
    """

    def on_dispatch(self, fence: int, snap) -> None:
        """Chunk ``fence`` dispatched; ``snap`` is its (unread)
        ``PendingSnapshot``."""

    def on_retire(self, fence: int) -> None:
        """Boundary ``fence`` read back; its deferred page frees released."""

    def on_observe(self, fence: int, pstate) -> None:
        """Proxy shadow of chunk ``fence`` observed (proxy mode only)."""

    def on_retract(self, fence: int) -> None:
        """Lagged retract for boundary ``fence`` dispatched (proxy mode)."""

    def on_harvest(self, fence: int, slots: list[int]) -> None:
        """Requests in ``slots`` finished at boundary ``fence``."""

    def on_admit(self, fence: int, slot: int) -> None:
        """A queued request admitted into ``slot`` while ``fence`` flies."""


def serve_overlapped(engine, ss, *, answer_len: int = 0,
                     record_trace: bool = False, eager: bool = False,
                     hooks: PipelineHooks | None = None) -> list[dict]:
    """The overlapped serve loop body.  ``ss`` is the namespace from
    ``ReasoningEngine._serve_setup`` (prefilled initial cohort, scheduler,
    allocators, proxy tier); results are identical in shape and, under
    greedy sampling, in content to the sync loop's.  ``eager`` runs each
    chunk as the guarded loop (host reads and all: for tests).  Leaves
    ``engine._ledger`` and ``engine.overlap_stats`` (chunks, idle chunks,
    skipped shadows, pages deferred) for the caller."""
    ex = engine.executor
    ecfg = engine.ecfg
    sched, alloc, ptier = ss.sched, ss.alloc, ss.ptier
    paged, proxy_mode = ss.paged, ptier is not None
    S, B, budget, chunk = ss.S, ss.B, ss.budget, ss.chunk
    tail = ss.tail
    state = ss.state
    hooks = hooks if hooks is not None else PipelineHooks()
    stats = engine.overlap_stats = {"chunks": 0, "idle_chunks": 0,
                                    "shadows_skipped": 0, "pages_deferred": 0}

    ledger = InFlightLedger()
    engine._ledger = ledger
    for s, _ in sched.bound():
        ledger.mark_admitted(s)                 # fence 0: never skipped

    # host mirrors from the last retired boundary (the setup's snapshot to
    # start); they lag the device by <= one dispatched chunk
    mirror_nr = ss.snap.n_reasoning.copy()
    mirror_outlen = ss.snap.out_len.copy()
    mirror_cur = ss.snap.cur
    # forced answers on their way, with the (slot, request) pairs they go to
    answers: list[tuple[ToHost, list]] = []

    def attach_answers():
        for got, rows in answers:
            ans = got.array()
            for s, req in rows:
                req.result["answer_tokens"] = ans[s].copy()
        answers.clear()

    def dispatch_tick():
        """Dispatch the next chunk without reading anything back."""
        nonlocal state
        bound = list(sched.bound())
        if paged:
            state = ex.ensure_chunk_pages(
                alloc, state, [s for s, _ in bound], chunk + tail, tail=tail,
                budget=budget, cur=mirror_cur, n_reasoning=mirror_nr,
                slack=chunk if ledger.in_flight else 0)
        state, snap = ex.decode_chunk_snapshot(
            state, budget, chunk, use_monitor=ss.gen_monitor, eager=eager)
        fence = ledger.open_fence()
        hooks.on_dispatch(fence, snap)
        return fence, snap, bound

    def process_boundary(fence, pending, bound):
        """Read boundary ``fence``'s snapshot (waits on that chunk only),
        reconcile, harvest and admit, all while the next chunk flies."""
        nonlocal state, mirror_cur
        snap = pending.wait()
        attach_answers()            # enqueued before the chunk in flight
        stats["chunks"] += 1
        stats["idle_chunks"] += snap.steps == 0
        nr, outlen, toks = snap.n_reasoning, snap.out_len, snap.tokens
        ledger.retire_fence(fence)          # releases deferred page frees
        hooks.on_retire(fence)
        # slots re-admitted while this chunk flew: their snapshot rows are
        # the PREVIOUS occupant's — ignore them everywhere below
        skip = ledger.admitted_after(fence)

        if proxy_mode:
            # shadow this boundary's emitted tokens through the proxy (on
            # its own stream, beside the generator's chunk in flight), then
            # reconcile the generator ONE boundary late: only proxy-stopped
            # rows rewind (retract_lagged)
            n_start = mirror_outlen.copy()
            n_emitted = outlen - n_start
            # a freed slot's row is stopped in the proxy (or emitted
            # nothing), and a re-admitted one's is the previous occupant's
            resident = {s for s, _ in sched.bound()} - skip
            n_emitted[[s for s in range(B) if s not in resident]] = 0
            if n_emitted.any():
                ptier.begin_chunk(chunk, [s for s, _ in sched.bound()])
                verdict = ptier.shadow(pending, n_start, n_emitted, chunk,
                                       eager=eager)
                hooks.on_observe(fence, ptier.state)
                state = ex.retract_lagged(state, *verdict)
                hooks.on_retract(fence)
            else:
                # no resident row emitted: the shadow would be an identity
                stats["shadows_skipped"] += 1
            psnap = ptier.snap
            new_n, pstop = psnap.n_reasoning, psnap.stop_flag

        if record_trace:
            # ``bound`` was captured at dispatch — exactly the rows that
            # decoded this chunk; already-finished requests self-guard
            src = psnap if proxy_mode else snap
            for s, req in bound:
                req.record_trace(src.n_reasoning[s], src.n_evals[s],
                                 src.var[s])

        active_eff = snap.active & ~pstop if proxy_mode else snap.active
        done = [(s, r) for s, r in sched.finished_slots(active_eff)
                if s not in skip]

        if answer_len and done:
            if paged:
                # a rollout writes </think> + answer_len slots past cur; the
                # chunk in flight may already have advanced the ring, so
                # over-map by one chunk of slack
                state = ex.ensure_chunk_pages(
                    alloc, state, [s for s, _ in sched.bound()],
                    answer_len + 1, cur=snap.cur,
                    slack=chunk if ledger.in_flight else 0)
            toks_ans, _ = engine.force_answer(state, answer_len, greedy=True,
                                              eager=eager)
            answers.append((ToHost(toks_ans), list(done)))

        for s, req in done:
            sched.release(s)
            ledger.mark_released(s, fence)
            if proxy_mode:
                n_fin = int(new_n[s]) if pstop[s] else int(nr[s])
                eat_s = bool(pstop[s])
                # recompute off the truncated stream — the snapshot's flag
                # may predate the lagged rewind
                ended_s = bool((toks[s, :n_fin] == ecfg.end_think_id).any())
            else:
                n_fin = int(nr[s])
                eat_s = bool(snap.stop_flag[s])
                ended_s = bool(snap.ended_think[s])
            req.finish(reasoning_tokens=toks[s, :n_fin].copy(),
                       n_reasoning=n_fin, ended_think=ended_s, eat_stop=eat_s)
            if paged:
                # the chunk in flight still maps this row's pages: park
                # them on the ledger until its fence retires
                ledger.defer_free(alloc, s)
            if proxy_mode:
                # the proxy's stream is idle past the shadow just read: its
                # pages go straight back to the pool
                ptier.free_row(s)
        if done:
            hooks.on_harvest(fence, [s for s, _ in done])

        # mirrors advance to this boundary's (post-verdict) values; skip
        # rows keep their admission-time values
        for s in range(B):
            if s in skip:
                continue
            if proxy_mode and pstop[s]:
                mirror_nr[s] = mirror_outlen[s] = new_n[s]
            else:
                mirror_nr[s], mirror_outlen[s] = nr[s], outlen[s]
        mirror_cur = snap.cur

        # admission sweeps EVERY free slot (deferred admissions included);
        # the ring guard uses the mirror plus one in-flight chunk of
        # headroom — an upper bound on the true pointer
        for s in (s for s, r in enumerate(sched.slots) if r is None):
            if sched.pending == 0:
                continue
            used_ub = mirror_cur + (chunk if ledger.in_flight else 0)
            sched.check_capacity(used_ub, "another admission")
            if proxy_mode:
                ptier.check_capacity("another admission")
            if not admit_or_defer(S, alloc,
                                  ptier.alloc if proxy_mode else None):
                continue
            nxt = sched.admit_next(s)
            one = engine.start(nxt.prompt[None], [nxt.prompt_len], ss.rng,
                               capacity=ss.C_pre if paged else None,
                               fresh=True)
            if paged:
                row_table = alloc.admit_row(s, S, used_ub)
                state = ex.admit_paged(state, one, s, row_table)
            else:
                state = ex.admit(state, one, s)
            if proxy_mode:
                ptier.admit(s, nxt.prompt, nxt.prompt_len, S)
            nxt.begin_decode()
            ledger.mark_admitted(s)
            mirror_nr[s] = mirror_outlen[s] = 1
            hooks.on_admit(ledger.fence, s)

    # ---- the pipeline: always dispatch ahead, then read the PREVIOUS
    # boundary.  The dispatch never waits to learn whether the batch
    # emptied: at most one all-idle chunk per drain more than the sync
    # loop, and one per cohort that finishes inside one chunk.
    try:
        with (ptier.overlapped() if proxy_mode
              else contextlib.nullcontext()):
            pend = None
            while True:
                while sched.running:
                    nxt_pend = dispatch_tick()
                    if pend is not None:
                        process_boundary(*pend)
                    pend = nxt_pend
                if pend is not None:
                    process_boundary(*pend)  # retires the last fence; may admit
                    pend = None
                    continue
                if sched.pending == 0:
                    break
                # every slot empty, queue non-empty, all fences retired and
                # every deferred free released: a pool genuinely too small
                if paged and not alloc.can_admit(S):
                    raise RuntimeError(
                        f"paged KV cache cannot hold a single request: "
                        f"{alloc.free_pages} pages free with every slot "
                        f"empty, but a prompt needs "
                        f"{alloc.blocks_for(S) + 1} pages. "
                        f"Raise CacheConfig.num_pages.")
                if proxy_mode and not ptier.can_admit(S):
                    raise RuntimeError(
                        f"proxy paged KV cache cannot hold a single "
                        f"request: {ptier.alloc.free_pages} pages free with "
                        f"every slot empty, but a prompt needs "
                        f"{ptier.alloc.blocks_for(S) + 1} pages. "
                        f"Raise ProxyConfig.cache.num_pages.")
                break
        attach_answers()
    finally:
        stats["pages_deferred"] = ledger.pages_deferred
    return [r.to_result() for r in ss.requests]
