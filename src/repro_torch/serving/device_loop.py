"""The decode chunk without the host: the eager chunk's one branch on
device data (``device_if``), and the runner that replays a whole chunk as
one CUDA graph (``ChunkGraphs``).

``device_if(pred, then_fn, else_fn)`` reads ``bool(pred)`` on the host and
runs one branch (the reference's ``lax.cond``, and the ``cond`` of its chunk
``lax.while_loop``).  Every host read of device data inside an eager decode
chunk or proxy shadow chunk goes through it: the guard of each step (some
row still going) and the lazy EAT probe (some active row due).
``device_if.calls`` counts those reads.

On the card a chunk is instead a fixed-length masked body with no branch:
``chunk_len`` steps, each masked by ``live`` (some row still going) on the
device, the probe on every step (the reference's ``make_eat_step(
probe_cond=False)``).  A step with ``live`` false is an identity on the
state and the cache, so the body gives the guarded loop's state bitwise
(``Executor.masked_chunk``).  ``ChunkGraphs`` captures that body once per
program key and replays it: no ``device_if`` read, no launch from Python.
A forced-answer rollout (``Executor.rollout``: ``</think>`` and ``n``
tokens, every step live) is captured and replayed the same way.
"""
from __future__ import annotations

import gc
import time
from typing import Callable

import torch


def device_if(pred: torch.Tensor, then_fn: Callable,
              else_fn: Callable | None = None):
    """``lax.cond(pred, then_fn, else_fn)`` on a 0-dim bool tensor: the
    output of the branch taken (None where ``else_fn`` is missing and
    ``pred`` is false).  One host read, counted in ``device_if.calls``."""
    device_if.calls += 1
    if bool(pred):
        return then_fn()
    return else_fn() if else_fn is not None else None


device_if.calls = 0


def launch_counters() -> list:
    """The kernel wrappers whose ``launches`` (and ``variant_launches``)
    count their kernels' launches."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.entropy_probe.ops import entropy_probe_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.paged_attention.ops import paged_attention_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda

    return [flash_attention_cuda, paged_attention_cuda, entropy_probe_cuda,
            ssd_scan_cuda, decode_attention_cuda]


def _counts() -> list[tuple[int, dict]]:
    return [(fn.launches, dict(getattr(fn, "variant_launches", {})))
            for fn in launch_counters()]


def _add_counts(delta, sign: int = 1) -> None:
    for fn, (n, variants) in zip(launch_counters(), delta):
        fn.launches += sign * n
        for v, k in variants.items():
            fn.variant_launches[v] += sign * k


#: the process's lane streams, by (device index, lane)
_LANES: dict = {}

#: the lane of the generator's graphs, and that of the proxy model's graphs
#: and of the overlapped serve's proxy tier
MAIN_LANE, SIDE_LANE = 0, 1


def lane_stream(device, lane: int) -> torch.cuda.Stream:
    """The process's stream of ``lane`` on ``device``: made at the first
    call, kept for the process, and never another lane's (the pool hands
    its 32 streams out in turn, so two calls of ``torch.cuda.Stream()`` may
    return the same one).  cuBLAS keys its workspace by (handle, stream): a
    graph captured on a stream bakes in that stream's workspace, so graphs,
    or a graph and eager work, that run at the same time on two streams must
    come from two lanes.  The generator's graphs capture on ``MAIN_LANE``;
    the proxy model's graphs capture on ``SIDE_LANE``, where the overlapped
    serve also runs the proxy tier's work.  A process holds two streams
    per device, however many engines it builds."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    s = _LANES.get((idx, lane))
    if s is None:
        taken = {t.cuda_stream for (i, _), t in _LANES.items() if i == idx}
        for _ in range(64):
            s = torch.cuda.Stream(idx)
            if s.cuda_stream not in taken:
                break
        else:
            raise RuntimeError("torch's stream pool gave no stream that is "
                               "not another lane's")
        _LANES[(idx, lane)] = s
    return s


class _Graph:
    def __init__(self, graph, bufs, outs, fixed, delta, generator):
        self.graph, self.bufs, self.outs, self.fixed = graph, bufs, outs, fixed
        self.delta, self.generator = delta, generator


class ChunkGraphs:
    """CUDA graphs of device programs, one per program key: the decode
    chunks (the reference's ``chunk_program`` key: batch, monitor on or off,
    cache kind and shape, page-list bucket width, ``chunk_len``, budget)
    and the forced-answer rollouts (its ``rollout_program`` key: batch,
    ``n``, greedy, cache kind and shape, bucket width).

    ``run(key, body, inputs, ...)`` replays the graph of ``key`` on
    ``inputs`` and returns new tensors holding its outputs.  On the first
    call of a key it captures ``body``:

    * fixed buffers, one per input (the small per-row state: a few KB), are
      made outside the graph's pool; before each replay the inputs are
      copied into them;
    * a warm-up runs the body once eagerly on a side stream, on ``idle``
      inputs (the inputs themselves where it is not given) that make it an
      identity on the cache (no row live); its outputs give the shapes of
      the fixed output buffers, also made outside the pool, into which the
      captured work copies the body's outputs at its end;
    * ``fixed`` are the cache tensors the graph reads and writes in place
      (K/V pools or ring, ``pos``, ``cur``, page table and page list, SSM
      states): a replay on any other tensors raises, and nothing falls back
      to the eager loop;
    * a sampled body draws from the graph's own generator, registered with
      the graph; before each replay the caller's generator state (seed and
      offset) is copied into it, and the caller's generator is left as it
      was (its owner moves it by the draws it keeps: ``Executor``);
    * the runner's graphs share one memory pool, the runner's own, and
      capture on the stream of its ``lane`` (``lane_stream``): graphs of
      one runner never run at the same time (its owner replays them on one
      stream), while the graphs of the generator's runner and the proxy's
      may (the overlapped serve replays the proxy's shadow chunks on a
      second stream), and must then neither alias their intermediates nor
      share a cuBLAS workspace.  The warm-up runs on the capture stream
      too.

    Launch counts: a wrapper counts the calls that run it, eager or under a
    capture.  The capture launches nothing, so its count delta is taken
    back out and added again at every replay, which is when the kernels
    run.  ``captures``, ``capture_s`` (seconds of each capture, warm-up
    included), ``replays`` and ``pool_bytes`` (the memory the captures
    added to the pool) describe the runner's work.
    """

    def __init__(self, lane: int = MAIN_LANE):
        self._graphs: dict = {}
        self.lane = lane
        # the runner's MemPool (a bare ``graph_pool_handle`` is freed with
        # the last graph that used it, and torch refuses to capture into
        # its id again), made at its first capture
        self._pool = None
        self.captures = 0
        self.capture_s: list[float] = []
        self.replays = 0
        self.pool_bytes = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> list:
        """The program keys captured so far, in capture order."""
        return list(self._graphs)

    def run(self, key, body: Callable, inputs: list, *, fixed: list,
            idle: list | None = None,
            generator: torch.Generator | None = None) -> tuple[list, int]:
        """``body(bufs, gen) -> outs`` (tensors; ``bufs`` hold ``inputs``);
        ``gen`` is the generator the body draws from (the graph's own, None
        without ``generator``).  Returns new tensors holding ``outs``, and
        the Philox offset the replay's draws took from ``generator``'s state
        (0 without one)."""
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(
                body, inputs, inputs if idle is None else idle, fixed, generator)
        elif len(fixed) != len(g.fixed) or any(
                a.data_ptr() != b.data_ptr() for a, b in zip(fixed, g.fixed)):
            raise RuntimeError(
                f"CUDA graph {key}: the cache is not the one it captured "
                f"(a cache the executor did not allocate, or one an eager "
                f"chunk replaced); no eager fallback runs on the card")
        for b, x in zip(g.bufs, inputs):
            b.copy_(x)
        drawn = 0
        if generator is not None:
            g.generator.set_state(generator.get_state())
            start = g.generator.get_offset()
        g.graph.replay()
        if generator is not None:
            drawn = g.generator.get_offset() - start
        self.replays += 1
        _add_counts(g.delta)
        return [b.clone() for b in g.outs], drawn

    def _capture(self, body, inputs, idle, fixed, generator) -> _Graph:
        t0 = time.perf_counter()
        dev = inputs[0].device
        bufs = [x.clone() for x in inputs]
        for b, x in zip(bufs, idle):
            b.copy_(x)
        own = None
        if generator is not None:
            own = torch.Generator(device=dev)
            own.set_state(generator.get_state())
        if self._pool is None:
            with torch.cuda.device(dev):
                self._pool = torch.cuda.MemPool()
        side = lane_stream(dev, self.lane)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = body(bufs, own)
        torch.cuda.current_stream(dev).wait_stream(side)
        outs = [torch.empty_like(o) for o in warm]
        del warm
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        if own is not None:
            graph.register_generator_state(own)
        # a dead runner's graphs and pool must not be freed mid-capture
        # (torch asserts, and the capture fails): no collection until it ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool.id, stream=side):
                for b, o in zip(outs, body(bufs, own)):
                    b.copy_(o)
        finally:
            if collecting:
                gc.enable()
        after = _counts()
        delta = [(a[0] - b[0], {v: a[1][v] - b[1].get(v, 0) for v in a[1]})
                 for a, b in zip(after, before)]
        _add_counts(delta, -1)
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.captures += 1
        self.capture_s.append(time.perf_counter() - t0)
        return _Graph(graph, bufs, outs, list(fixed), delta, own)
