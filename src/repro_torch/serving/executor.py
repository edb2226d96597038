"""Executor layer: the device work of the serving stack (port of
``repro/serving/executor.py``: the self-EAT path, the proxy tier's shadow
decode, and the overlapped loop's snapshot and lagged retract).

The reference builds one jitted program per operation and donates the
decode state into it.  PyTorch runs eagerly, so each operation here is a
method that updates the state's cache in place.  The decode chunk (the
reference's one-dispatch ``while_loop`` over the canonical EAT step,
``make_eat_step``, non-fused: a committed ``decode_step`` followed by a
non-committing ``probe_entropy``) has two forms:

* on the card, one replay of a CUDA graph (``device_loop.ChunkGraphs``)
  of ``masked_chunk``: ``chunk_len`` steps with no branch, each masked by
  ``live`` on the device and probing every step (``probe_cond=False``);
  a step with no row live leaves the state and the cache exactly as they
  were;
* on the CPU, or with ``eager=True``, the guarded Python loop: each step
  under ``device_if`` (``serving/device_loop.py``) with the lazy probe,
  whose predicate reads are the only host reads in a chunk.

Both give the same state bitwise.  A sampled replay draws on every step,
masked or not, from the graph's own generator, which starts each replay
from the state's generator; that generator then moves by the draws of the
live steps only (``settle_rng``, when ``snapshot`` reads the step count),
as the guarded loop moves it, so every later draw is the same on both
paths.  The overlapped loop cannot wait for the step count:
``decode_chunk_snapshot`` moves the generator by the whole replay's draws,
so its sampled streams differ from the sync loop's (greedy ones do not).
A forced-answer rollout has the same two forms: on the card one replay of
its graph (every step live, so the caller's generator moves by all of the
replay's draws), otherwise the eager loop.  The host reads a chunk's
outcome once, through ``snapshot``: the packed copy goes to pinned memory
behind the chunk on the stream and the host waits on an event after it
(``PendingSnapshot``).  The executor keeps the serving caches it
allocates and the page-list buffers it fills, and empties them in place
for the next serve, so the graphs it captured replay across serves.  A
caller must treat a state it hands to a mutating method (``decode_chunk``, ``decode_chunk_snapshot``,
``decode_step``, ``admit``, ``admit_paged``, ``retract``, ``retract_lagged``,
``observe_chunk``) as consumed and go on from the returned one.

  cache_for      the kept ring / recurrent cache of a batch, emptied
  paged_cache_for  the kept paged cache of a batch, emptied
  prefill        prompt -> cache fill (the cache it is given)
  decode_chunk   up to chunk_len monitored steps (a graph replay on the card)
  masked_chunk   the chunk_len masked steps a chunk graph captures
  probe          non-committing EAT evaluation (the cache survives)
  admit          slot recycling row-merge (ring)
  admit_paged    row-merge through a page table
  pack_paged     dense prefill -> page pool
  decode_step    one unmonitored step (the per-token loop's)
  rollout        forced answer generation (a graph replay on the card);
                 leaves the cache as it was
  retract        proxy mode: rewind rows to the proxy's exit step
  retract_lagged the overlapped loop's retract, one boundary late
  observe_chunk  (ProxyExecutor) shadow a generator chunk through the proxy
  snapshot       the packed host copy of a state (one device-to-host read)
  snapshot_async the same copy on its way: waited on later
  decode_chunk_snapshot  decode_chunk, then snapshot_async behind it

Beside the executor: ``make_eat_step`` (the canonical monitored step; with
``fused_probe`` the reference's §Perf step, ``Model.decode_and_probe``,
which the chunks do not use, as the reference's engine does not) and
``build_serve_step_program`` (the reference's every-token dry-run
program, single-device: ``ServeStepConfig``, ``serve_monitor``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.eat import ProbeSpec, eval_eat
from repro_torch.core.monitor import MonitorState, ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.device import upload, upload_into
from repro_torch.models.common import positions_for
from repro_torch.models.transformer import preserved_slots, write_slots
from repro_torch.serving.cache import (
    alloc_cache,
    alloc_paged_cache,
    blocks_arrays,
    cache_leaves,
    commit_layers,
    freeze_inactive_rows,
    is_recurrent,
    merge_cache_row,
    merge_paged_row,
    pack_paged_cache,
    reset_cache,
)
from repro_torch.serving.device_loop import (
    SIDE_LANE,
    ChunkGraphs,
    device_if,
    lane_stream,
)
from repro_torch.serving.sampler import SamplerConfig, logprob_of, sample


#: the archs whose caches hold recurrent (SSM) state: a step's new state is
#: rolled back for inactive rows (``freeze_inactive_rows``) and copied back
#: into the cache's own tensors after a prefill or a chunk (``commit_layers``)
RECURRENT_ARCHS = ("ssm", "hybrid")


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
    steps: torch.Tensor         # () int64 steps the last chunk took


#: Column order of the integer block of a packed snapshot (the reference's
#: ``SNAP_ROWS``); ``cur`` (the shared ring pointer) and ``steps`` (the
#: last chunk's step count) are broadcast per row.  The debiased EMA
#: variance follows as float32 bits, then ``out_tokens``.
SNAP_ROWS = ("active", "n_reasoning", "out_len", "ended_think", "stop_flag",
             "n_evals", "cur", "steps")


@dataclasses.dataclass
class Snapshot:
    """The host's copy of a decode state after a chunk (``Executor.snapshot``),
    and between chunks the host's mirror of it: an admission updates the
    recycled row (``admit``) without reading the device."""

    active: np.ndarray          # (B,) bool
    n_reasoning: np.ndarray     # (B,) int64
    out_len: np.ndarray         # (B,) int64
    ended_think: np.ndarray     # (B,) bool
    stop_flag: np.ndarray       # (B,) bool
    n_evals: np.ndarray         # (B,) int64
    cur: int                    # the cache's committed length
    var: np.ndarray             # (B,) float32 debiased EMA variance
    tokens: np.ndarray          # (B, T_buf) int64 out_tokens
    steps: int                  # steps the last chunk took (device count)

    @classmethod
    def unpack(cls, host: np.ndarray) -> "Snapshot":
        n = len(SNAP_ROWS)
        f = {name: host[:, i].copy() for i, name in enumerate(SNAP_ROWS)}
        for name in ("active", "ended_think", "stop_flag"):
            f[name] = f[name].astype(bool)
        f["cur"] = int(f["cur"][0])
        f["steps"] = int(f["steps"][0])
        var = host[:, n].astype(np.int32).view(np.float32)
        return cls(var=var, tokens=host[:, n + 1:].copy(), **f)

    def admit(self, row: int, prompt_width: int) -> None:
        """A fresh request in ``row`` (prefilled over ``prompt_width``
        slots, its first token sampled): active, one token, and ``cur`` at
        least the prompt width, as the device's admission sets them."""
        self.active[row] = True
        self.n_reasoning[row] = self.out_len[row] = 1
        self.stop_flag[row] = False
        self.n_evals[row] = 0
        self.cur = max(self.cur, prompt_width)


class ToHost:
    """A device tensor on its way to the host: copied, not blocking the
    host, into pinned memory behind the work enqueued so far on the
    current stream, with an event recorded after the copy.  ``array``
    waits on that event alone, so work enqueued after it (the next chunk)
    runs on; on the CPU there is nothing to wait for."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        self.host = t
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def array(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class PendingSnapshot(ToHost):
    """A packed snapshot on its way to the host (``Executor.snapshot_async``);
    ``wait`` gives the ``Snapshot``.  ``packed`` is the device tensor and
    ``tokens`` its ``out_tokens`` part: a consumer on another stream waits
    on ``event`` first."""

    def __init__(self, packed: torch.Tensor):
        super().__init__(packed)
        self.packed = packed
        self._snap = None

    @property
    def tokens(self) -> torch.Tensor:
        return self.packed[:, len(SNAP_ROWS) + 1:]

    def wait(self) -> Snapshot:
        if self._snap is None:
            self._snap = Snapshot.unpack(self.array())
        return self._snap


def prompt_positions(prompt_len, S: int, device) -> torch.Tensor:
    """(B, S) positions of LEFT-padded prompts: 0..len-1, pad slots -1."""
    plen = upload(prompt_len, device, torch.int32)
    pos1d = (torch.arange(S, dtype=torch.int32, device=device)[None, :]
             - (S - plen)[:, None])
    return torch.where(pos1d >= 0, pos1d, -1)


def make_eat_step(model, monitor: ReasoningMonitor | None,
                  sampler: SamplerConfig, *, window: int | None = None,
                  probe_cond: bool = True, fused_probe: bool = False):
    """Build ``step(cache, token, pos1d, mon, active, rng, live=None)`` ->
    ``(next_token, mon, stop)``: one committed decode step (its commit
    masked by ``live``, see ``Model.decode_step``), the sampler, then the
    monitor transition.  ``probe_cond=True`` runs the probe only when an
    evaluation is due for some active row (the reference's ``lax.cond``);
    ``probe_cond=False`` probes every step, which a step with no row due
    leaves unused (``ReasoningMonitor.update`` with ``use`` all false is
    ``tick_no_eval``).  token/pos1d: (B, 1).

    ``fused_probe`` (with a monitor): ONE forward over ``[token, probe...]``
    at positions ``pos1d + [0, 1 + m)`` (``Model.decode_and_probe``, which
    commits the token alone), the sampler, then the monitor's update with
    that step's EAT, every step.  It takes no ``live``: the engine's
    chunks build the step non-fused, as the reference's do."""
    cfg = model.cfg

    def fused(cache, token, pos1d, mon: MonitorState, active, rng):
        B, m = token.shape[0], len(monitor.probe)
        probe_toks = torch.stack([torch.full((B,), t, dtype=torch.long,
                                             device=token.device)
                                  for t in monitor.probe.tokens], 1)
        pos_all = (pos1d[:, :1]
                   + torch.arange(1 + m, dtype=torch.int32, device=pos1d.device)[None])
        logits, eat = model.decode_and_probe(
            token, positions_for(cfg, pos_all), pos_all, cache, probe_toks,
            window=window)
        nxt = sample(logits[:, -1], cfg.vocab, sampler, rng)
        mon = monitor.update(mon, eat, monitor.due(mon, nxt), active)
        return nxt, mon, mon.stop_flag

    def step(cache, token, pos1d, mon: MonitorState, active, rng, live=None):
        if monitor is not None and fused_probe:
            if live is not None:
                raise ValueError("the fused decode-and-probe step takes no live "
                                 "mask: a masked chunk builds the step non-fused")
            return fused(cache, token, pos1d, mon, active, rng)
        logits = model.decode_step(token, positions_for(cfg, pos1d), pos1d, cache,
                                   window=window, live=live)
        nxt = sample(logits[:, -1], cfg.vocab, sampler, rng)
        if monitor is None:
            return nxt, mon, torch.zeros_like(active)
        next_pos = pos1d[:, -1] + 1
        mon = monitor.observe(
            mon, lambda: eval_eat(model, cache, monitor.probe, next_pos),
            nxt, active, lazy=probe_cond)
        return nxt, mon, mon.stop_flag

    return step


@dataclasses.dataclass(frozen=True)
class ServeStepConfig:
    """The every-token serve step's settings (the reference's dry-run
    program, single-device): the probe is ``</think>`` + the answer prefix,
    and ``fused_probe`` folds it into the decode forward.  The step always
    probes, and attends over the config's own ``sliding_window``."""

    probe: ProbeSpec = ProbeSpec((1, 6))
    stopper: EATStopper = EATStopper(alpha=0.2, delta=1e-3)
    sampler: SamplerConfig = SamplerConfig()
    fused_probe: bool = False


def serve_monitor(scfg: ServeStepConfig) -> ReasoningMonitor:
    """The serve step's evaluation schedule: a probe every token, no
    warmup (the most expensive configuration of the monitored step)."""
    return ReasoningMonitor(stopper=scfg.stopper, probe=scfg.probe,
                            schedule="every_n", every_n=1, min_evals=0)


def build_serve_step_program(model, scfg: ServeStepConfig, cache: dict):
    """ONE every-token EAT step over ``cache``'s batch, every row active
    (the reference's ``build_serve_step_program`` without a mesh).

    Returns ``(step, mon)``: ``step(cache, token, pos1d, mon, rng)`` ->
    ``(next_token, mon, stop)`` (token/pos1d (B, 1); the cache updated in
    place; ``rng`` a ``torch.Generator`` or None for a greedy sampler), and
    the monitor's initial state for the batch.  The probe runs every step,
    unconditionally (``probe_cond=False``), so the step has no host read
    and captures into a CUDA graph as it is."""
    monitor = serve_monitor(scfg)
    eat_step = make_eat_step(model, monitor, scfg.sampler, probe_cond=False,
                             fused_probe=scfg.fused_probe)

    def step(cache, token, pos1d, mon: MonitorState, rng):
        active = torch.ones(token.shape[:1], dtype=torch.bool, device=token.device)
        return eat_step(cache, token, pos1d, mon, active, rng)

    B = cache["pos"].shape[0]
    return step, monitor.init(B, cache["pos"].device)


def make_shadow_step(model, monitor: ReasoningMonitor, *,
                     probe_cond: bool = True):
    """Build the proxy-side forced-token EAT step ``step(cache, tok_in,
    tok_out, next_pos, mon, valid, live=None)`` -> ``(mon, new_pos)``,
    updating the cache in place (the commit masked by ``live``; the probe
    lazy unless ``probe_cond`` is False, as in ``make_eat_step``).

    The mirror of ``make_eat_step`` for a model that does not choose the
    tokens: ``tok_in`` (B, 1) is the token the generator fed at this step
    (committed into the proxy cache), ``tok_out`` (B,) the token it emitted
    (the monitor's due-check input), ``valid`` (B,) the rows still consuming
    the stream.  Invalid rows write at position -1 (masked) and their
    monitor state freezes, as inactive rows do in the self-EAT step, so a
    proxy running the generator's own weights reproduces the self-EAT EMA
    trajectory bit for bit.  The committed forward skips the unembedding:
    the proxy's logits at the stream token are never read."""
    cfg = model.cfg
    recurrent = cfg.arch_type in RECURRENT_ARCHS

    def step(cache, tok_in, tok_out, next_pos, mon: MonitorState, valid,
             live=None):
        pos1d = torch.where(valid, next_pos, -1)[:, None]
        before = list(cache["layers"]) if recurrent else None
        model.prefill(tok_in, positions_for(cfg, pos1d), pos1d, cache, live=live)
        if before is not None:
            freeze_inactive_rows(cache, before, valid)
        new_pos = next_pos + valid.int()
        mon = monitor.observe(
            mon, lambda: eval_eat(model, cache, monitor.probe, new_pos),
            tok_out, valid, lazy=probe_cond)
        return mon, new_pos

    return step


def _put_row(big, small, slot: int) -> None:
    """Row ``slot`` of every tensor leaf of ``big`` <- row 0 of ``small``."""
    if isinstance(big, torch.Tensor):
        big[slot] = small[0]
        return
    for b, s in zip(big, small):
        _put_row(b, s, slot)


def _flat(tree) -> list:
    """The tensors of a ``ServeState`` other than its cache (and its
    ``rng``), nested NamedTuples in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, ServeState):
        return [t for name in ServeState._fields if name not in ("cache", "rng")
                for t in _flat(getattr(tree, name))]
    return [t for x in tree for t in _flat(x)]


def _unflat(tree, tensors):
    """``tree`` with the tensors of ``_flat`` replaced, in order."""
    it = iter(tensors)

    def rebuild(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, ServeState):
            return t._replace(**{name: rebuild(getattr(t, name))
                                 for name in ServeState._fields
                                 if name not in ("cache", "rng")})
        return type(t)(*(rebuild(x) for x in t))

    return rebuild(tree)


def _select(live, new: ServeState, old: ServeState) -> ServeState:
    """``new`` where the 0-dim ``live`` is true, else ``old``, field by
    field (a tensor the step wrote in place is the same object in both)."""
    return _unflat(new, [a if a is b else torch.where(live, a, b)
                         for a, b in zip(_flat(new), _flat(old))])


class Executor:
    """Every device operation ``ReasoningEngine`` drives."""

    def __init__(self, model, ecfg, monitor: ReasoningMonitor):
        self.model = model
        self.ecfg = ecfg
        self.monitor = monitor
        self.cfg = model.cfg
        self._recurrent = model.cfg.arch_type in RECURRENT_ARCHS
        self._step_mon = make_eat_step(model, monitor, ecfg.sampler)
        self._step_every = make_eat_step(model, monitor, ecfg.sampler,
                                         probe_cond=False)
        self._step_plain = make_eat_step(model, None, ecfg.sampler)
        #: the chunk graphs (on the card)
        self.graphs = ChunkGraphs()
        #: device-to-host snapshot copies made (``snapshot``)
        self.snapshot_reads = 0
        # the last sampled replay's generator, its offset before the replay,
        # the offset of one step's draws and the steps tensor (settle_rng)
        self._draws = None
        # the caches this executor allocated, each with its first layer
        # entries, and the page-list buffers per (B, NB, bucket width)
        self._caches: dict = {}
        self._blocks: dict = {}

    # ---------------------------------------------------------- caches
    def _kept(self, key, alloc) -> dict:
        """The cache kept under ``key`` (``alloc()`` the first time),
        emptied in place for a new serve, its first layer entries back in
        place (an eager recurrent chunk replaces them)."""
        if key not in self._caches:
            cache = alloc()
            self._caches[key] = (cache, list(cache["layers"]))
            return cache
        cache, layers = self._caches[key]
        cache["layers"] = list(layers)
        return reset_cache(cache)

    def cache_for(self, batch: int, capacity: int) -> dict:
        """The empty ring cache (with recurrent states for arch ``ssm`` and
        ``hybrid``) of
        ``batch`` rows × ``capacity`` slots: the same tensors at every call,
        so the chunk graphs captured over them replay.  The cache of an
        earlier call is emptied: its state is consumed."""
        return self._kept(("ring", batch, capacity), lambda: alloc_cache(
            self.cfg, batch, capacity, device=self.model.device))

    def paged_cache_for(self, batch: int, capacity: int, page_size: int,
                        num_pages: int, *, alloc=None,
                        native: bool = False) -> dict:
        """The empty paged cache every paged serve starts from (kept as
        ``cache_for``); in page-native mode the allocator's current
        compacted page list is put in (later refreshes ride
        ``put_page_table``)."""
        cache = self._kept(
            ("paged", batch, capacity, page_size, num_pages),
            lambda: alloc_paged_cache(self.cfg, batch, capacity, page_size,
                                      num_pages, device=self.model.device))
        if native:
            self._put_blocks(cache, alloc.block_buckets(alloc.bucket_width()))
        return cache

    def _put_blocks(self, cache: dict, blocks: tuple) -> None:
        """Copy the compacted page list ``(pages, logical, counts)`` into
        the buffers of its bucket width (kept across calls: a graph captured
        at one width replays after the width moved away and back)."""
        pages = np.asarray(blocks[0], np.int32)
        key = (pages.shape[0], cache["page_table"].shape[1], pages.shape[1])
        buf = self._blocks.get(key)
        if buf is None:
            buf = self._blocks[key] = blocks_arrays(*blocks,
                                                    device=self.model.device)
        else:
            for name, x in zip(("pages", "logical", "count"), blocks):
                upload_into(buf[name], np.asarray(x, np.int32))
        cache["blocks"] = buf

    # ---------------------------------------------------------- decode
    def _advance(self, state: ServeState, budget: int, step_fn,
                 live=None) -> ServeState:
        """One monitored decode step + engine bookkeeping, all masked by
        row; with ``live`` (0-dim bool) the whole step is masked too: where
        it is false the cache and the state come back as they were."""
        ecfg = self.ecfg
        tok = state.last_token[:, None]
        # inactive rows still ride through the batched step, but their KV
        # write must be invisible: pos=-1 keeps it out of every later mask
        pos1d = torch.where(state.active, state.next_pos, -1)[:, None]
        # ... and an SSM state is rolled back to the entries before the step
        # (a commit replaces them, so these stay intact)
        before = list(state.cache["layers"]) if self._recurrent else None
        nxt, mon, stop = step_fn(state.cache, tok, pos1d, state.monitor,
                                 state.active, state.rng, live)
        if before is not None:
            freeze_inactive_rows(state.cache, before, state.active)
        nxt = torch.where(state.active, nxt, ecfg.pad_id)
        ended = state.ended_think | (state.active & (nxt == ecfg.end_think_id))
        rows = torch.arange(nxt.shape[0], device=nxt.device)
        put = nxt
        if live is not None:
            put = torch.where(live, nxt, state.out_tokens[rows, state.out_len])
        state.out_tokens[rows, state.out_len] = put
        inc = state.active.long()
        n_reasoning = state.n_reasoning + inc
        over = n_reasoning >= budget
        new = ServeState(
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
            steps=state.steps + 1,
        )
        return new if live is None else _select(live, new, state)

    def _guarded(self, state: ServeState, chunk_len: int, cond,
                 advance) -> ServeState:
        """The reference's chunk ``while_loop``: up to ``chunk_len`` steps,
        step ``i`` run as ``device_if(cond(state, i), advance(state, i))``.
        The predicate only falls inside a chunk, so the loop leaves at the
        first false one."""
        state = state._replace(steps=torch.zeros_like(state.steps))
        for i in range(chunk_len):
            nxt = device_if(cond(state, i), lambda: advance(state, i))
            if nxt is None:
                break
            state = nxt
        return state

    def _masked(self, state: ServeState, chunk_len: int, live_of,
                advance) -> ServeState:
        """The chunk a CUDA graph captures: ``chunk_len`` steps, none
        skipped, step ``i`` being ``advance(state, i, live)`` with ``live =
        live_of(state, i)`` kept on the device (an identity where it is
        false); ``steps`` counts the live ones.  A recurrent cache's final
        states are copied into the tensors the chunk started from."""
        kept = list(state.cache["layers"]) if self._recurrent else None
        state = state._replace(steps=torch.zeros_like(state.steps))
        for i in range(chunk_len):
            state = advance(state, i, live_of(state, i))
        if kept is not None:
            commit_layers(state.cache, kept)
        return state

    def _replay(self, tag, state: ServeState, extra: tuple, body, idle_at: int,
                chunk_len: int, sampled: bool) -> ServeState:
        """``body(state, *extra) -> state`` (a masked chunk) as one replay
        of its CUDA graph: the state's small tensors and ``extra`` are the
        graph's inputs, its cache the tensors it updates in place.  The
        warm-up before a capture zeroes input ``idle_at`` (``active``, or
        the shadow's ``n_emitted``), which leaves no row live."""
        cache = state.cache
        small = _flat(state)
        inputs = small + list(extra)
        idle = list(inputs)
        idle[idle_at] = torch.zeros_like(inputs[idle_at])
        gen = (_generator(state.rng, state.active.device)
               if sampled and not self.ecfg.sampler.greedy else None)
        key = _graph_key(tag, cache)

        def run(bufs, rng):
            st = _unflat(state._replace(rng=rng), bufs[:len(small)])
            return _flat(body(st, *bufs[len(small):]))

        outs, drawn = self.graphs.run(key, run, inputs, idle=idle,
                                      fixed=cache_leaves(cache), generator=gen)
        out = _unflat(state, outs)
        if gen is not None:
            self._draws = (gen, gen.get_offset(), drawn // chunk_len,
                           out.steps)
        return out

    def settle_rng(self, steps: int | None = None) -> None:
        """Move the generator of the last sampled replay past the draws of
        its live steps (``steps``, or read from the device when no snapshot
        gave it): where the guarded loop, which draws only on live steps,
        leaves it.  ``snapshot`` calls it with the count it read; the other
        users of the generator (the next chunk, a rollout, an admission's
        first token) call it first."""
        if self._draws is None:
            return
        gen, start, per_step, steps_t = self._draws
        self._draws = None
        gen.set_offset(start + per_step * (int(steps_t) if steps is None
                                           else steps))

    def decode_chunk(self, state: ServeState, budget: int, chunk_len: int, *,
                     use_monitor: bool = True,
                     eager: bool = False) -> ServeState:
        """Advance up to ``chunk_len`` tokens.  On the card (unless
        ``eager``): one replay of the graph of ``masked_chunk`` (captured
        at the first call of its key).  Otherwise the guarded loop, which
        stops once no row is active.  CONSUMES ``state``."""
        self.settle_rng()
        if state.active.is_cuda and not eager:
            return self._replay(
                ("decode", use_monitor, budget, chunk_len), state, (),
                lambda st: self.masked_chunk(st, budget, chunk_len,
                                             use_monitor=use_monitor),
                idle_at=0, chunk_len=chunk_len, sampled=True)
        step_fn = self._step_mon if use_monitor else self._step_plain
        return self._guarded(
            state, chunk_len, lambda s, i: s.active.any(),
            lambda s, i: self._advance(s, budget, step_fn))

    def masked_chunk(self, state: ServeState, budget: int, chunk_len: int, *,
                     use_monitor: bool = True) -> ServeState:
        """``chunk_len`` decode steps, each masked by ``active.any()`` and
        probing every step (``probe_cond=False``): the body the card's
        chunk graph captures, run eagerly.  Equal to ``decode_chunk``'s
        guarded loop bitwise (a sampled one draws on all ``chunk_len``
        steps: its generator is not settled).  CONSUMES ``state``."""
        step_fn = self._step_every if use_monitor else self._step_plain
        return self._masked(
            state, chunk_len, lambda s, i: s.active.any(),
            lambda s, i, live: self._advance(s, budget, step_fn, live))

    def decode_step(self, state: ServeState) -> ServeState:
        """One unmonitored decode step (``_advance`` with no budget): the
        per-token loop's step (``ReasoningEngine._reason_per_token``).  The
        reference's ``decode_program`` returns a new state; here the cache
        is updated in place, so the step CONSUMES ``state``: a caller that
        times one state again and again steps a copy of its cache."""
        self.settle_rng()
        return self._advance(state, NO_BUDGET, self._step_plain)

    def snapshot(self, state: ServeState) -> Snapshot:
        """The packed host copy of ``state`` after a chunk: one int64 block
        (``SNAP_ROWS`` columns, the debiased EMA variance's bits, then
        ``out_tokens``) in ONE device-to-host copy, waited for."""
        snap = self.snapshot_async(state).wait()
        if self._draws is not None and self._draws[3] is state.steps:
            self.settle_rng(snap.steps)
        return snap

    def snapshot_async(self, state: ServeState) -> PendingSnapshot:
        """``snapshot``'s copy, enqueued on the stream and not waited for
        (counted in ``snapshot_reads`` here)."""
        B = state.active.shape[0]
        cols = [state.active, state.n_reasoning, state.out_len,
                state.ended_think, state.monitor.stop_flag,
                state.monitor.n_evals, state.cache["cur"].expand(B),
                state.steps.expand(B)]
        var = self.monitor.stopper.debiased_var(state.monitor.stop_state)
        packed = torch.cat([torch.stack([c.long() for c in cols], 1),
                            var.float().view(torch.int32).long()[:, None],
                            state.out_tokens.long()], 1)
        self.snapshot_reads += 1
        return PendingSnapshot(packed)

    def decode_chunk_snapshot(self, state: ServeState, budget: int,
                              chunk_len: int, *, use_monitor: bool = True,
                              eager: bool = False
                              ) -> tuple[ServeState, PendingSnapshot]:
        """``decode_chunk``, then its snapshot enqueued right behind it on
        the stream (the overlapped loop's dispatch, the reference's
        ``decode_chunk_snapshot``): the host reads it one boundary late,
        after the next chunk is dispatched.  A sampled replay moves the
        state's generator by all of its draws (nothing is read to count
        the live steps), so a sampled overlapped stream differs from the
        sync loop's, as in the reference; the eager loop draws on live
        steps only.  CONSUMES ``state``."""
        state = self.decode_chunk(state, budget, chunk_len,
                                  use_monitor=use_monitor, eager=eager)
        if self._draws is not None:
            self.settle_rng(chunk_len)
        return state, self.snapshot_async(state)

    # ---------------------------------------------------------- prefill/probe
    def prefill(self, tokens, positions, pos1d, cache, *, frames=None,
                image_embeds=None) -> torch.Tensor:
        """Prompt prefill into ``cache`` (in place); returns hidden.
        ``positions`` are ``positions_for(cfg, pos1d)``.  A recurrent
        cache's new states are copied into its tensors, which stay the
        ones it was allocated with; so are an encoder-decoder's cross K/V,
        made from ``frames`` (``Model.prefill``).  A VLM's ``image_embeds``
        (B, P, d) go in front of ``tokens``, the positions covering both."""
        kept = list(cache["layers"]) if self._recurrent else None
        hidden = self.model.prefill(tokens, positions, pos1d, cache,
                                    frames=frames, image_embeds=image_embeds)
        if kept is not None:
            commit_layers(cache, kept)
        return hidden

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
        mode, its compacted buckets ``(pages, logical, counts)`` — into the
        cache's buffers (copies: the tensors a chunk graph captured stay
        the cache's)."""
        cache = state.cache
        upload_into(cache["page_table"], np.asarray(table, np.int32))
        if blocks is not None:
            self._put_blocks(cache, blocks)
        return state

    def ensure_chunk_pages(self, alloc, state: ServeState, slots, span: int,
                           *, cur: int, tail: int = 0,
                           budget: int | None = None, n_reasoning=None,
                           slack: int = 0) -> ServeState:
        """Map (and push) pages covering the next ``span`` logical slots for
        every slot in ``slots`` before a writing operation.  With ``budget``
        the span is clamped per row to the tokens it can still emit plus
        the probe ``tail``.  ``cur`` and ``n_reasoning`` (with ``budget``)
        are the host's mirror of the state, never read from the device.
        The overlapped loop's mirrors lag the device by up to one chunk in
        flight, so it also passes ``slack`` (that chunk's length): slots
        ``cur .. cur + slack + span`` are mapped, at most one chunk of pages
        too many per row.  The upload is skipped while the mapping is
        unchanged."""
        for s in slots:
            sp = span
            if budget is not None:
                sp = min(span, max(1, budget - int(n_reasoning[s])) + tail)
            alloc.ensure(s, cur, cur + slack + sp)
        if not alloc.dirty:
            return state
        blocks = (alloc.block_buckets(alloc.bucket_width())
                  if "blocks" in state.cache else None)
        return self.put_page_table(state, alloc.snapshot(), blocks)

    # ---------------------------------------------------------- proxy mode
    def retract(self, state: ServeState, new_n, pmon: MonitorState
                ) -> ServeState:
        """Proxy-mode chunk-boundary reconciliation: rewind every row to the
        proxy's exit decision and install the proxy's monitor state.

        The generator decodes whole chunks blind, so a row the proxy stopped
        at emitted-token count ``new_n[b] < n_reasoning[b]`` has overshot.
        This truncates ``out_tokens`` to ``new_n`` (pad after), rewinds
        ``next_pos`` / ``n_reasoning`` / ``out_len``, masks the overshoot
        K/V in place (``pos >= new next_pos`` -> -1, slot-agnostic, so ring
        and paged caches alike), re-derives ``ended_think`` over the kept
        tokens, clears ``active`` where the proxy stopped and takes a copy
        of ``pmon`` as the state's monitor.  A row with no overshoot passes
        through unchanged.  CONSUMES ``state``."""
        return self._rewind(state, new_n, pmon)

    def retract_lagged(self, state: ServeState, new_n, pmon: MonitorState
                       ) -> ServeState:
        """The overlapped loop's reconciliation, one chunk boundary late:
        ``new_n`` / ``pmon`` are the proxy's verdict on chunk N while
        ``state`` has already decoded chunk N+1.  Rows the proxy stopped
        rewind as in ``retract`` (their chunk-N overshoot and their whole
        chunk N+1 masked away); every other row keeps its chunk-N+1 tokens,
        which the proxy has yet to observe (``eff = where(stop, new_n,
        n_reasoning)``).  A copy of ``pmon`` becomes the state's monitor,
        as in ``retract``.  CONSUMES ``state``."""
        new_n = upload(new_n, state.n_reasoning.device, state.n_reasoning.dtype)
        return self._rewind(state, torch.where(pmon.stop_flag, new_n,
                                               state.n_reasoning), pmon)

    def _rewind(self, state: ServeState, new_n, pmon: MonitorState
                ) -> ServeState:
        """Every row to ``new_n`` emitted tokens (the rest masked out of the
        cache and the buffer), ``active`` cleared where ``pmon`` stopped,
        a copy of ``pmon`` the monitor."""
        ecfg = self.ecfg
        new_n = upload(new_n, state.n_reasoning.device).to(
            state.n_reasoning.dtype, copy=True)
        next_pos = state.next_pos - (state.n_reasoning - new_n).to(
            state.next_pos.dtype)
        pos = state.cache["pos"]
        pos.masked_fill_(pos >= next_pos[:, None], -1)
        out = state.out_tokens
        cols = torch.arange(out.shape[1], device=out.device)[None]
        keep = cols < new_n[:, None]
        last = out.gather(1, (new_n - 1)[:, None])[:, 0]
        # the </think> latch over the KEPT tokens only: a natural end the
        # generator hit past the proxy's stop point never happened
        ended = (torch.where(keep, out, -1) == ecfg.end_think_id).any(-1)
        out.masked_fill_(~keep, ecfg.pad_id)
        return ServeState(
            cache=state.cache,
            rng=state.rng,
            active=state.active & ~pmon.stop_flag,
            next_pos=next_pos,
            last_token=last,
            n_reasoning=new_n,
            monitor=_clone(pmon),
            ended_think=ended,
            out_tokens=out,
            out_len=new_n.clone(),
            steps=state.steps,
        )

    # ---------------------------------------------------------- answers
    def rollout(self, cache, next_pos, rng, *, n: int, greedy: bool = False,
                eager: bool = False):
        """Forced answer rollout: append </think> then generate ``n``
        tokens.  Returns (tokens (B, n), logprobs (B, n)); the cache is left
        as it was.  On the card (unless ``eager``): one replay of the graph
        of ``_rollout_body`` (captured at the first call of its key: batch,
        ``n``, greedy, cache kind and shape, bucket width), whose fixed
        inputs are ``next_pos`` and copies of the cache's ``pos`` and
        ``cur``.  A sampled replay draws from the graph's own generator,
        loaded from ``rng`` (the default generator where it is None); every
        step of a rollout is live, so ``rng`` then moves by the replay's
        draws, to where the eager loop leaves it.  Otherwise the eager loop
        of ``n + 1`` decode forwards."""
        self.settle_rng()
        if not next_pos.is_cuda or eager:
            return self._rollout_body(cache, next_pos, cache["pos"].clone(),
                                      cache["cur"].clone(), rng, n=n,
                                      greedy=greedy)
        gen = None if greedy else _generator(rng, next_pos.device)
        (toks, lps), drawn = self.graphs.run(
            _graph_key(("rollout", n, greedy), cache),
            lambda bufs, g: self._rollout_body(cache, *bufs, g, n=n,
                                               greedy=greedy),
            [next_pos, cache["pos"], cache["cur"]], fixed=cache_leaves(cache),
            generator=gen)
        if gen is not None:
            gen.set_offset(gen.get_offset() + drawn)
        return toks, lps

    def _rollout_body(self, cache, next_pos, pos, cur, rng, *, n: int,
                      greedy: bool):
        """The rollout over ``cache`` with ``pos`` and ``cur`` its private
        copies, which the rollout's commits advance (as does a recurrent
        cache's copied layer list; a commit replaces SSM entries, never
        writes them); every live slot it overwrites is restored."""
        model, cfg, ecfg = self.model, self.cfg, self.ecfg
        B = next_pos.shape[0]
        local = dict(cache, pos=pos, cur=cur, layers=list(cache["layers"]))
        slots = write_slots(cur, n + 1, pos.shape[1], next_pos.device)
        scfg = dataclasses.replace(ecfg.sampler, greedy=greedy)
        toks, lps = [], []
        with preserved_slots(cache, slots):
            et = torch.full((B, 1), ecfg.end_think_id, dtype=torch.long,
                            device=next_pos.device)
            pos1d = next_pos[:, None]
            logit = model.decode_step(et, positions_for(cfg, pos1d), pos1d,
                                      local)[:, -1]
            p = next_pos + 1
            for _ in range(n):
                tok = sample(logit, cfg.vocab, scfg, rng)
                toks.append(tok)
                lps.append(logprob_of(logit, tok, cfg.vocab))
                p1 = p[:, None]
                logit = model.decode_step(tok[:, None], positions_for(cfg, p1), p1,
                                          local)[:, -1]
                p = p + 1
        return torch.stack(toks, 1), torch.stack(lps, 1)


#: the per-token loop's budget: none (the reference's int32 maximum)
NO_BUDGET = 2**31 - 1


def _generator(rng: torch.Generator | None, device) -> torch.Generator:
    """The generator a sampled graph's draws stand for: ``rng``, or the
    device's default one."""
    return rng if rng is not None else torch.cuda.default_generators[
        device.index or 0]


def _graph_key(tag, cache) -> tuple:
    """A graph's program key: ``tag`` and the cache's kind, shape (a paged
    cache's pool too: the overlapped loop's pool holds one row more) and
    page-list bucket width."""
    blocks = cache.get("blocks")
    paged = "page_table" in cache
    pool = ()
    if paged:
        slotted = next(e for e in cache["layers"] if not is_recurrent(e))
        pool = tuple(next(iter(slotted.values())).shape[:2])
    return (tag, tuple(cache["pos"].shape), paged, pool,
            0 if blocks is None else blocks["pages"].shape[1])


def _clone(tree):
    """A copy of every tensor of a (nested) NamedTuple: the generator's
    state gets rows written in place at admission, the proxy's must not
    see them."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(x) for x in tree))


class ProxyExecutor(Executor):
    """The device work of the proxy (black-box monitor) model.

    The proxy tier (paper §4.2, Fig. 5) is a second model with its own KV
    cache (ring, or paged with its own page pool) that shadows the
    generator's emitted chunks and computes EAT from its own logits.  Its
    decode state is a ``ServeState`` whose ``rng`` / ``last_token`` /
    ``out_tokens`` are inert bookkeeping, so prefill, admission, packing and
    page-table pushes are inherited from ``Executor`` unchanged; the one new
    operation is ``observe_chunk``, the forced-input shadow decode."""

    def __init__(self, model, ecfg, monitor: ReasoningMonitor):
        super().__init__(model, ecfg, monitor)
        self._shadow = make_shadow_step(model, monitor)
        self._shadow_every = make_shadow_step(model, monitor, probe_cond=False)
        # the proxy's graphs may replay beside the generator's
        self.graphs = ChunkGraphs(SIDE_LANE)

    def side_stream(self) -> torch.cuda.Stream:
        """The stream the overlapped loop runs the proxy's work on: the
        side lane's (``device_loop.lane_stream``), the one its graphs were
        captured on."""
        return lane_stream(self.model.device, SIDE_LANE)

    def _shadow_fns(self, toks, n_start, n_emitted):
        """(``valid_of(s, i)``, ``advance(s, i, live=None)``) of the shadow
        chunk over the generator's tokens ``toks``."""
        last_col = toks.shape[1] - 1

        def valid_of(s, i):
            return (i < n_emitted) & ~s.monitor.stop_flag

        def advance(s, i, live=None):
            valid = valid_of(s, i)
            # a valid row's columns lie inside the buffer; an invalid row's
            # token only feeds a masked write, so its column is clamped
            tok_in = toks.gather(1, (n_start + i - 1).clamp(0, last_col)[:, None])
            tok_out = toks.gather(1, (n_start + i).clamp(0, last_col)[:, None])[:, 0]
            step = self._shadow if live is None else self._shadow_every
            mon, new_pos = step(s.cache, tok_in, tok_out, s.next_pos,
                                s.monitor, valid, live)
            inc = valid.long()
            new = s._replace(
                monitor=mon,
                next_pos=new_pos,
                last_token=torch.where(valid, tok_out, s.last_token),
                n_reasoning=s.n_reasoning + inc,
                out_len=s.out_len + inc,
                active=valid & ~mon.stop_flag,
                steps=s.steps + 1,
            )
            return new if live is None else _select(live, new, s)

        return valid_of, advance

    def observe_chunk(self, pstate: ServeState, gen_tokens, n_start,
                      n_emitted, chunk_len: int, *,
                      eager: bool = False) -> ServeState:
        """Shadow one generator chunk through the proxy model.

        ``gen_tokens`` (B, T) is the generator's ``out_tokens`` after the
        chunk; ``n_start`` (B,) the per-row emitted count before it and
        ``n_emitted`` (B,) the tokens it added (device tensors or host
        arrays).  Step ``i`` commits the token the generator consumed
        (``gen_tokens[b, n_start + i - 1]``) and due-checks the one it
        emitted (``gen_tokens[b, n_start + i]``).  A row stops consuming the
        moment its stop latches, so the proxy cache never ingests overshoot
        tokens.  The loop runs exactly while ``i < chunk_len`` and some row
        is valid (``valid = (i < n_emitted) & ~stop_flag``, which only falls
        as ``i`` grows): each step advances the proxy cache's shared
        ``cur``, so a step past that point is masked whole (``live =
        valid.any()``, as in ``masked_observe``), or it would move every
        later slot.  On the card (unless ``eager``) one replay of the graph
        of ``masked_observe``; otherwise the guarded loop.  CONSUMES
        ``pstate``."""
        dev = pstate.active.device
        toks = upload(gen_tokens, dev)
        n_start = upload(n_start, dev, torch.long)
        n_emitted = upload(n_emitted, dev, torch.long)
        if pstate.active.is_cuda and not eager:
            return self._replay(
                ("shadow", chunk_len), pstate, (toks, n_start, n_emitted),
                lambda st, t, s0, ne: self.masked_observe(st, t, s0, ne,
                                                          chunk_len),
                idle_at=-1, chunk_len=chunk_len, sampled=False)
        valid_of, advance = self._shadow_fns(toks, n_start, n_emitted)
        return self._guarded(pstate, chunk_len,
                             lambda s, i: valid_of(s, i).any(), advance)

    def masked_observe(self, pstate: ServeState, toks, n_start, n_emitted,
                       chunk_len: int) -> ServeState:
        """The shadow chunk a CUDA graph captures, run eagerly:
        ``chunk_len`` steps, each masked by ``valid.any()`` and probing
        every step.  Equal to ``observe_chunk``'s guarded loop bitwise.
        ``toks``, ``n_start``, ``n_emitted``: device tensors.  CONSUMES
        ``pstate``."""
        valid_of, advance = self._shadow_fns(toks, n_start, n_emitted)
        return self._masked(pstate, chunk_len,
                            lambda s, i: valid_of(s, i).any(), advance)
