"""The port's ``InFlightLedger`` with its ``PageAllocator`` (pure host;
the port's counterpart of the ledger and overlap-schedule tests in
tests/test_scheduler.py).

* Fences: a harvested row's pages stay out of the free list while a
  chunk is in flight and come back when its fence retires; released at
  once when nothing flies; fences retire strictly in order; a slot is
  never admitted while occupied nor released off an un-retired fence; the
  skip set of a fence is exactly the slots admitted while it flew.
* The allocator's double-free guard behind ``release_pages``.
* Random schedules (20 seeded, and a ``hypothesis`` search) of dispatch,
  retire, admit, harvest and growth never double-free or double-map a
  page, never admit into an occupied slot, and drain to quiescence.
"""
import numpy as np
import pytest

from repro_torch.serving.scheduler import InFlightLedger, PageAllocator


def test_ledger_defer_free_waits_for_fence():
    alloc = PageAllocator(num_pages=12, page_size=8, n_blocks=8, batch=2)
    led = InFlightLedger()
    led.mark_admitted(0)
    alloc.admit_row(0, 12, cur=16)                       # 3 pages
    free_before = alloc.free_pages

    f = led.open_fence()
    assert led.in_flight and not led.quiescent
    assert led.defer_free(alloc, 0) == 3
    assert led.pages_deferred == 3
    # detached: unmapped (trash) but NOT free — parked on the ledger
    assert (alloc.table[0] == 0).all()
    assert alloc.free_pages == free_before
    assert alloc.pages_in_use == 3

    led.retire_fence(f)
    assert alloc.free_pages == free_before + 3
    assert alloc.pages_in_use == 0
    assert led.quiescent


def test_ledger_release_immediate_when_quiescent():
    alloc = PageAllocator(num_pages=12, page_size=8, n_blocks=8, batch=2)
    led = InFlightLedger()
    f = led.open_fence()
    led.retire_fence(f)
    alloc.admit_row(1, 12, cur=16)
    assert led.defer_free(alloc, 1) == 3
    assert alloc.free_pages == 11                        # all data pages free
    assert led.quiescent


def test_ledger_retire_out_of_order_raises():
    led = InFlightLedger()
    led.open_fence()
    led.open_fence()
    with pytest.raises(RuntimeError, match="out of order"):
        led.retire_fence(2)                              # skips fence 1
    with pytest.raises(RuntimeError, match="out of order"):
        led.retire_fence(3)                              # never opened
    led.retire_fence(1)
    led.retire_fence(2)
    with pytest.raises(RuntimeError, match="out of order"):
        led.retire_fence(2)                              # double retire


def test_ledger_admit_into_occupied_slot_raises():
    led = InFlightLedger()
    led.mark_admitted(3)
    with pytest.raises(RuntimeError, match="still occupied"):
        led.mark_admitted(3)
    f = led.open_fence()
    led.retire_fence(f)
    led.mark_released(3, f)
    assert led.mark_admitted(3) == led.fence


def test_ledger_release_guards():
    led = InFlightLedger()
    led.mark_admitted(0)
    led.open_fence()
    with pytest.raises(RuntimeError, match="un-retired fence"):
        led.mark_released(0, 1)
    led.retire_fence(1)
    with pytest.raises(RuntimeError, match="not occupied"):
        led.mark_released(2, 1)
    led.mark_released(0, 1)


def test_ledger_admitted_after_skip_set():
    led = InFlightLedger()
    led.mark_admitted(0)                  # fence 0: the initial cohort
    f1 = led.open_fence()
    led.mark_admitted(1)                  # while chunk 1 flies
    assert led.admitted_after(f1) == {1}
    assert led.admitted_after(f1 + 1) == set()
    led.retire_fence(f1)
    f2 = led.open_fence()
    assert led.admitted_after(f2) == set()


def test_ledger_empty_detach_parks_nothing():
    alloc = PageAllocator(num_pages=12, page_size=8, n_blocks=8, batch=2)
    led = InFlightLedger()
    led.open_fence()
    assert led.defer_free(alloc, 0) == 0
    assert led.pages_deferred == 0 and not led._pending


def test_allocator_double_free_guard():
    alloc = PageAllocator(num_pages=12, page_size=8, n_blocks=8, batch=2)
    alloc.admit_row(0, 12, cur=16)
    pages = alloc.detach_row(0)
    alloc.release_pages(pages)
    with pytest.raises(RuntimeError, match="double free"):
        alloc.release_pages(pages)                       # already free
    alloc.admit_row(0, 12, cur=16)
    with pytest.raises(RuntimeError, match="double free"):
        alloc.release_pages(alloc._owned[0][:1])         # owned, not parked


# ------------------------- overlap scheduler property (random schedules)
def _run_pipeline_schedule(ops, *, num_pages=12, batch=4, prompt=6):
    """Drive PageAllocator + InFlightLedger through an arbitrary legal op
    sequence the way serving/pipeline.py does, checking page conservation
    after every step (every data page exactly one of free, owned by a row,
    parked on the ledger), then drain to quiescence."""
    alloc = PageAllocator(num_pages=num_pages, page_size=4, n_blocks=8,
                          batch=batch)
    led = InFlightLedger()
    occupied: set[int] = set()
    grown: dict[int, int] = {}

    def check_conservation():
        free = set(alloc.free)
        owned = [p for row in alloc._owned for p in row]
        parked = [p for _, _, pages in led._pending for p in pages]
        assert len(owned) == len(set(owned)), "page owned twice"
        assert len(free) == alloc.free_pages
        assert sorted(list(free) + owned + parked) == list(range(1, num_pages))

    for kind, slot, arg in ops:
        slot = slot % batch
        if kind == 0:                                    # dispatch a chunk
            led.open_fence()
        elif kind == 1 and led.in_flight:                # read a boundary
            led.retire_fence(led.retired + 1)
        elif kind == 2 and slot not in occupied:         # admit
            if alloc.can_admit(prompt):
                alloc.admit_row(slot, prompt, cur=arg % 32)
                led.mark_admitted(slot)
                occupied.add(slot)
                grown[slot] = prompt
        elif kind == 3 and slot in occupied:             # harvest + free
            led.mark_released(slot, led.retired)
            led.defer_free(alloc, slot)
            occupied.discard(slot)
        elif kind == 4 and slot in occupied:             # decode growth
            hi = min(grown[slot] + arg % 8, 31)
            if alloc.free_pages >= alloc.blocks_for(hi + 1):
                alloc.ensure(slot, 0, hi)
                grown[slot] = hi
        check_conservation()

    while led.in_flight:
        led.retire_fence(led.retired + 1)
        check_conservation()
    for slot in sorted(occupied):
        led.mark_released(slot, led.retired)
        led.defer_free(alloc, slot)
        check_conservation()
    assert led.quiescent
    assert alloc.pages_in_use == 0
    assert alloc.free_pages == num_pages - 1


@pytest.mark.parametrize("seed", range(20))
def test_overlap_schedule_seeded_random(seed):
    rng = np.random.default_rng(seed)
    ops = [(int(k), int(s), int(a))
           for k, s, a in zip(rng.integers(0, 5, 200), rng.integers(0, 4, 200),
                              rng.integers(0, 32, 200))]
    _run_pipeline_schedule(ops)


def test_overlap_schedule_property_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    op = st.tuples(st.integers(0, 4), st.integers(0, 3), st.integers(0, 31))

    @settings(max_examples=60, deadline=None)
    @given(ops=st.lists(op, max_size=120), num_pages=st.integers(4, 24))
    def run(ops, num_pages):
        _run_pipeline_schedule(ops, num_pages=num_pages)

    run()
