"""Scheduler layer: slot allocation + admission policy for continuous
batching (copy of ``repro/serving/scheduler.py``).  Pure host-side Python
over ``Request`` objects; its device-facing outputs are slot ids and the
int32 page table.

* ring — ``SlotScheduler.check_capacity`` refuses an admission that would
  wrap the shared cache ring (capacity is a batch-lifetime bound).
* paged — ``PageAllocator`` turns that into per-block bookkeeping: admit
  whenever the free list covers the prompt blocks plus one decode page;
  an exiting request's pages return to the free list at harvest.
* overlap — ``InFlightLedger`` keeps the overlapped serve loop's fences
  (``serving/pipeline.py``): a harvested row's pages wait for the chunk in
  flight, and a slot admitted while a chunk flies is skipped in its
  snapshot.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Iterator, Optional

import numpy as np

from repro_torch.serving.request import Request, RequestStatus


class SlotScheduler:
    """FIFO slot scheduler over a fixed-size continuous batch."""

    def __init__(self, requests: list[Request], batch_size: int, *,
                 capacity: int, budget: int):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.requests = list(requests)
        self.queue: deque[Request] = deque(
            r for r in self.requests if r.status is RequestStatus.QUEUED
        )
        self.slots: list[Optional[Request]] = [None] * batch_size
        self.capacity = capacity
        self.budget = budget

    # ----------------------------------------------------------- admission
    def start_batch(self) -> list[Request]:
        """Admit the initial cohort: fill every slot from the queue (fewer
        requests than slots leaves the tail slots empty)."""
        cohort = []
        for slot in range(len(self.slots)):
            if not self.queue:
                break
            req = self.queue.popleft()
            req.admit(slot)
            self.slots[slot] = req
            cohort.append(req)
        return cohort

    def admit_next(self, slot: int) -> Optional[Request]:
        """Recycle a freed ``slot`` with the next queued request (None when
        the queue has drained).  The request comes back PREFILLING; the
        serve loop flips it to DECODING once its row is merged in."""
        if self.slots[slot] is not None:
            raise RuntimeError(f"slot {slot} is still occupied by request "
                               f"{self.slots[slot].rid}")
        if not self.queue:
            return None
        req = self.queue.popleft()
        req.admit(slot)
        self.slots[slot] = req
        return req

    # ------------------------------------------------------------- harvest
    def release(self, slot: int) -> Request:
        req = self.slots[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} is already free")
        self.slots[slot] = None
        return req

    def finished_slots(self, active_mask) -> list[tuple[int, Request]]:
        """Slots whose resident request stopped decoding this chunk:
        ``active_mask`` is the host copy of ``ServeState.active``."""
        return [(s, r) for s, r in enumerate(self.slots)
                if r is not None and not bool(active_mask[s])]

    def bound(self) -> Iterator[tuple[int, Request]]:
        """(slot, request) pairs currently resident in the batch."""
        return ((s, r) for s, r in enumerate(self.slots) if r is not None)

    @property
    def running(self) -> bool:
        return any(r is not None for r in self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue)

    # ------------------------------------------------------ capacity guard
    @staticmethod
    def required_capacity(prompt_width: int, n_requests: int,
                          batch_size: int, budget: int) -> int:
        """Cache slots needed for a batch-lifetime run of the ring cache:
        the shared ``cur`` pointer advances one slot per batch-wide decode
        step and never rewinds, so capacity must cover the prompt width
        plus every cohort's worst-case budget (one extra cohort of slack
        for admissions that straddle cohort boundaries).  The single
        sizing rule for every caller (CLI, benchmarks) of ``serve()``."""
        cohorts = math.ceil(n_requests / batch_size) + 1
        return prompt_width + cohorts * budget

    def check_capacity(self, used: int, when: str) -> None:
        """Refuse work that would wrap the shared cache ring.  ``used`` is
        the committed ring length (``int(state.cache['cur'])``)."""
        if used + self.budget > self.capacity:
            raise RuntimeError(
                f"EngineConfig.capacity={self.capacity} cannot hold "
                f"{when}: {used} slots committed + up to {self.budget} "
                f"decode steps would wrap the cache ring. Size capacity "
                f"to the batch-lifetime token count "
                f"(~prompt_width + ceil(n_requests / batch_size) * budget)."
            )


def pools_can_admit(prompt_tokens: int, *allocs) -> bool:
    """Admission gate across every page pool a request must enter (the
    generator's, plus the proxy tier's in ``monitor="proxy"`` serving).
    ``allocs`` entries may be None (that cache is a ring — no page gate) or
    a ``PageAllocator``; admission defers unless every pool present can
    cover the prompt blocks plus one decode page.  Deliberately all-or-
    nothing BEFORE any pool allocates, so a half-admitted request can never
    strand pages in one pool while waiting on the other."""
    return all(a.can_admit(prompt_tokens) for a in allocs if a is not None)


def admit_or_defer(prompt_tokens: int, *allocs) -> bool:
    """``pools_can_admit``, and on a refusal one deferral counted on each
    pool that is short (so generator-pool and proxy-pool pressure stay
    apart in the stats)."""
    if pools_can_admit(prompt_tokens, *allocs):
        return True
    for a in allocs:
        if a is not None and not a.can_admit(prompt_tokens):
            a.deferrals += 1
    return False


class PageAllocator:
    """Free-page bookkeeping for the block-paged KV cache (pure host).

    Owns the authoritative page table: a (batch, n_blocks) int32 array
    mapping each row's logical blocks (``slot // page_size``) to physical
    pages of the executor-side pool.  Page ``serving.cache.PAGE_TRASH`` (0)
    is reserved: unmapped entries point at it, so a row without a mapping
    writes into (and reads position-masked garbage from) the trash page
    instead of corrupting a neighbour.  The engine pushes ``table`` to the
    device before every chunk dispatch (replicated — a few KB of int32).

    This is what turns the ring cache's batch-lifetime capacity bound into
    per-block bookkeeping: ``can_admit`` asks only whether the free list
    covers the prompt plus one decode page, and ``free_row`` returns an
    exiting request's pages to the free list the moment it is harvested —
    in the same batch, those pages back the next admission.
    """

    def __init__(self, num_pages: int, page_size: int, n_blocks: int,
                 batch: int, *, sizing_knob: str = "CacheConfig.num_pages"):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved "
                             "as the trash page)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.n_blocks = n_blocks
        # which config field the exhaustion error tells the operator to
        # raise — the proxy tier's pool is sized by ProxyConfig, not the
        # engine's CacheConfig
        self.sizing_knob = sizing_knob
        self.table = np.zeros((batch, n_blocks), np.int32)
        # LIFO free list -> a freed page is the next one handed out, which
        # maximises page reuse within a batch (and the reuse counter below
        # proves it happened)
        self.free: list[int] = list(range(num_pages - 1, 0, -1))
        self._owned: list[list[int]] = [[] for _ in range(batch)]
        self._ever_used: set[int] = set()
        self.pages_reused = 0
        self.peak_pages_in_use = 0
        # admission ATTEMPTS this pool gated (the request stayed queued
        # because THIS pool's free list could not cover it) — the engine
        # increments it per gated sweep attempt, so the same deferred
        # request re-attempted at a later chunk boundary (or into another
        # free slot) counts again; it distinguishes proxy-pool pressure
        # from generator-pool pressure in tests and stats
        self.deferrals = 0
        # True whenever self.table differs from the last snapshot() — the
        # engine skips the per-chunk host->device table upload when clean
        self.dirty = True

    # ------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self.free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_admit(self, prompt_tokens: int) -> bool:
        """Admission rule: free pages must cover the prompt blocks plus one
        decode page.  (The decode page is usually shared with the batch's
        current block, but one page of headroom keeps the rule local.)"""
        return self.free_pages >= self.blocks_for(prompt_tokens) + 1

    # ---------------------------------------------------------- transitions
    def map_block(self, row: int, block: int) -> int:
        """Map ``row``'s logical ``block`` to a fresh physical page."""
        if self.table[row, block] != 0:
            return int(self.table[row, block])
        if not self.free:
            raise RuntimeError(
                f"paged KV cache exhausted: 0 of {self.num_pages - 1} data "
                f"pages free while mapping block {block} of row {row}. "
                f"Size {self.sizing_knob} to the peak live-token count "
                f"(~batch * (prompt + budget) / page_size), or lower the "
                f"batch size."
            )
        page = self.free.pop()
        if page in self._ever_used:
            self.pages_reused += 1
        self._ever_used.add(page)
        self.table[row, block] = page
        self._owned[row].append(page)
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        self.dirty = True
        return page

    def ensure(self, row: int, start_slot: int, end_slot: int) -> None:
        """Map every block covering logical slots [start_slot, end_slot]
        for ``row`` — called before each chunk/rollout dispatch with the
        slot range the device program may write."""
        end_slot = min(end_slot, self.n_blocks * self.page_size - 1)
        for block in range(start_slot // self.page_size,
                           end_slot // self.page_size + 1):
            self.map_block(row, block)

    def admit_row(self, row: int, prompt_slots: int, cur: int) -> np.ndarray:
        """Fresh mapping for an admitted request: its prompt blocks
        [0, ceil(prompt_slots/ps)) plus the batch's current decode block.
        Returns the (n_blocks,) row table (the ``admit`` program's input).
        The row must have been freed (``free_row``) first."""
        if self._owned[row]:
            raise RuntimeError(f"row {row} still owns pages — free_row() "
                               f"before re-admitting")
        self.ensure(row, 0, max(prompt_slots - 1, 0))
        self.map_block(row, min(cur // self.page_size, self.n_blocks - 1))
        return self.table[row].copy()

    def detach_row(self, row: int) -> list[int]:
        """Unmap ``row`` WITHOUT returning its pages to the free list (the
        first half of ``free_row``).  Returns the detached pages in
        ownership order."""
        pages = self._owned[row]
        self._owned[row] = []
        self.table[row] = 0
        if pages:
            self.dirty = True
        return pages

    def release_pages(self, pages: list[int]) -> None:
        """Second half of a deferred free: put detached ``pages`` back on
        the free list.  Guards against double-frees — a page must be
        neither already free nor owned by any row."""
        owned = {p for row in self._owned for p in row}
        for p in pages:
            if p in self.free or p in owned:
                raise RuntimeError(
                    f"double free of page {p}: already "
                    f"{'free' if p in self.free else 'owned'}"
                )
        self.free.extend(reversed(pages))

    def free_row(self, row: int) -> int:
        """Return all of ``row``'s pages to the free list (harvest time)
        and unmap the row.  Returns the number of pages freed."""
        pages = self.detach_row(row)
        self.release_pages(pages)
        return len(pages)

    def snapshot(self) -> np.ndarray:
        """The table to push to the device; marks the allocator clean.
        MUST be followed by an actual device update (the engine's
        ``put_page_table``) — skipping it would leave a freed row's stale
        mapping live on device, aliasing reused pages."""
        self.dirty = False
        return self.table

    # ------------------------------------------- page-native read indices
    #
    # The page-native attention path (kernels/paged_attention) reads K/V
    # through a COMPACTED per-row page list instead of the sparse (B, NB)
    # table: rank j of row b holds the j-th mapped logical block (ascending
    # logical order — required: the block scan must visit blocks in the
    # same order the ring comparator does).  The list is a pure function of
    # ``table``, so it can never drift from the admit/retract/free
    # bookkeeping above: every mutation goes through map_block / free_row,
    # and the engine re-derives the buckets at each dirty push.

    def mapped_counts(self) -> np.ndarray:
        """(batch,) mapped blocks per row — the kernel's per-row loop
        bound.  Retract never unmaps (a rewound row still owns its pages),
        so counts only change at map_block / free_row."""
        return (self.table != 0).sum(axis=1).astype(np.int32)

    @property
    def max_mapped_blocks(self) -> int:
        return int(self.mapped_counts().max(initial=0))

    def bucket_width(self, granule: int = 4) -> int:
        """Static bucket width covering every row's mapped count, rounded
        up to ``granule`` blocks so the jitted programs retrace every few
        pages of growth instead of every page."""
        need = max(self.max_mapped_blocks, 1)
        return min(-(-need // granule) * granule, self.n_blocks)

    def block_buckets(self, width: int) -> tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
        """(pages, logical, counts): the compacted mapped-page list, padded
        to ``width`` ranks with the trash page (identity steps)."""
        B = self.table.shape[0]
        pages = np.zeros((B, width), np.int32)
        logical = np.zeros((B, width), np.int32)
        counts = np.zeros((B,), np.int32)
        for b in range(B):
            blocks = np.flatnonzero(self.table[b])        # ascending logical
            n = len(blocks)
            if n > width:
                raise ValueError(f"bucket width {width} < {n} mapped blocks "
                                 f"of row {b} — size with bucket_width()")
            pages[b, :n] = self.table[b, blocks]
            logical[b, :n] = blocks
            counts[b] = n
        return pages, logical, counts


class InFlightLedger:
    """Fence bookkeeping for the overlapped serve loop (pure host).

    The pipeline (``serving.pipeline``) dispatches chunk N+1 before the
    host has harvested chunk N, so two chunk-boundary invariants the sync
    loop gets for free need explicit tracking:

    * **Deferred page frees** — a harvested row's KV pages may still be
      READ by the chunk already in flight (its page table was copied at
      dispatch).  ``defer_free`` detaches the pages from the allocator
      (table entries go to trash, so the *next* table push stops writes)
      but parks them on this ledger; they only re-enter the free list when
      the fence open at detach time retires.

    * **In-flight slot admission** — a slot freed at boundary N must not
      be re-admitted in a way that double-books it, and a row admitted
      DURING the tick that dispatched chunk F carries stale data in chunk
      F's snapshot (the old occupant's) — ``admitted_after(F)`` is the
      skip-set the boundary harvest uses to ignore those rows.

    Fences are dense integers: ``open_fence`` stamps each dispatched
    chunk, ``retire_fence`` retires them strictly in order (the pipeline
    harvests boundaries in dispatch order; out-of-order retirement is a
    pipeline bug and raises).
    """

    def __init__(self):
        self.fence = 0        # last fence opened (0 = nothing dispatched)
        self.retired = 0      # last fence retired
        self._pending: list[tuple[int, PageAllocator, list[int]]] = []
        self._admitted_at: dict[int, int] = {}
        self._occupied: set[int] = set()
        self.pages_deferred = 0   # stat: pages that ever waited on a fence

    # -------------------------------------------------------------- fences
    @property
    def in_flight(self) -> bool:
        return self.fence > self.retired

    @property
    def quiescent(self) -> bool:
        return not self._pending and self.fence == self.retired

    def open_fence(self) -> int:
        self.fence += 1
        return self.fence

    def retire_fence(self, fence: int) -> None:
        if fence != self.retired + 1 or fence > self.fence:
            raise RuntimeError(
                f"fence {fence} retired out of order (last retired "
                f"{self.retired}, last opened {self.fence})"
            )
        self.retired = fence
        self._drain()

    def _drain(self) -> None:
        ready = [e for e in self._pending if e[0] <= self.retired]
        self._pending = [e for e in self._pending if e[0] > self.retired]
        for _, alloc, pages in ready:
            alloc.release_pages(pages)

    # --------------------------------------------------------- page frees
    def defer_free(self, alloc: PageAllocator, row: int) -> int:
        """Detach ``row``'s pages from ``alloc`` and hold them until the
        fence currently open retires (released immediately when nothing is
        in flight).  Returns the number of pages deferred."""
        pages = alloc.detach_row(row)
        if not pages:
            return 0
        self._pending.append((self.fence, alloc, pages))
        self.pages_deferred += len(pages)
        self._drain()
        return len(pages)

    # ----------------------------------------------------------- slot book
    def mark_admitted(self, slot: int) -> int:
        """Record ``slot`` (re)admitted at the current fence.  Raises if
        the ledger still considers the slot occupied — admitting into an
        in-flight slot is the bug the property tests hunt."""
        if slot in self._occupied:
            raise RuntimeError(f"slot {slot} admitted while still occupied")
        self._occupied.add(slot)
        self._admitted_at[slot] = self.fence
        return self.fence

    def mark_released(self, slot: int, fence: int) -> None:
        """Record ``slot`` released at boundary ``fence`` — which must
        already have retired (a release decided off a still-speculative
        snapshot would be a pipeline bug)."""
        if fence > self.retired:
            raise RuntimeError(
                f"slot {slot} released at un-retired fence {fence} "
                f"(last retired {self.retired})"
            )
        if slot not in self._occupied:
            raise RuntimeError(f"slot {slot} released but not occupied")
        self._occupied.discard(slot)

    def admitted_after(self, fence: int) -> set[int]:
        """Slots whose current occupant was admitted at or after ``fence``
        opened — their rows in fence ``fence``'s snapshot belong to the
        PREVIOUS occupant and must be skipped by the boundary harvest."""
        return {s for s, f in self._admitted_at.items() if f >= fence}
