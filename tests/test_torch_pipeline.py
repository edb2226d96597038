"""The port's overlapped serve loop (``serve(overlap=True)``,
``serving/pipeline.py``) on the CPU: the port's counterpart of
tests/test_async_serve.py.

* Overlapped == sync inside the port, greedy, on ``tiny`` (chunk 8, budget
  24, answers of 4, traces recorded) across {ring, paged} x {self, proxy}
  x {delta 1e9, 0.0}, and on ``tiny-ssm`` through the ring: bitwise,
  tokens, exits, slots, answers and EAT traces.
* Ring offsets.  A request's EAT variances depend on where its keys sit
  inside the attention's page blocks, in the sync loop alone (prompts
  left-padded by half a page change their last bits, by a whole page
  nothing).  With exits at mixed boundaries (delta 4.45) the pipeline
  admits requests behind a chunk that still runs, a part of a page later
  than the sync loop does: everything stays exact but those requests'
  variances, which differ in their last bits; the JAX package's
  overlapped serve of the same workload differs from its sync serve in
  the same requests.
* Against the JAX package's ``serve(overlap=True)`` on the ring x self
  and paged x proxy (``tiny-proxy``) corners: tokens, exits and answers
  exactly, EAT traces within 1e-5.
* ``PipelineHooks`` schedules: waiting on every snapshot at dispatch
  (harvest before dispatch) changes nothing; chunk F+1 is dispatched
  before boundary F is read; the proxy's verdict lands exactly one
  boundary late; a lagged retract across page edges (page size 4); a
  harvested row's pages wait for the fence in flight and come back; mid-
  serve admissions with recorded traces read no stale row.
* The launcher's ``--overlap on``, and its refusal without ``--requests``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as jget
from repro.core.eat import make_probe as jprobe
from repro.core.monitor import ReasoningMonitor as JMonitor
from repro.core.stopping import EATStopper as JStopper
from repro.data.synthetic import ChainTask, Tokens
from repro.models import Model as JModel
from repro.serving.cache import CacheConfig as JCache
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReasoningEngine as JEngine
from repro.serving.proxy import ProxyConfig as JProxyConfig
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.models.model import Model
from repro_torch.params import from_jax
from repro_torch.serving.cache import CacheConfig
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.pipeline import PipelineHooks
from repro_torch.serving.proxy import ProxyConfig
from repro_torch.serving.sampler import SamplerConfig

from _torch_threads import _one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
BATCH = 4


def _pair(arch, seed):
    """The JAX model and params, and the port's model on the same weights."""
    jmodel = JModel(jget(arch), attn_impl="xla")
    params = jmodel.init(jax.random.PRNGKey(seed))
    cfg = get_config(arch)
    model = Model(cfg, from_jax(jax.tree_util.tree_map(np.asarray, params),
                                cfg, "cpu"))
    return jmodel, params, model


@pytest.fixture(scope="module")
def gen():
    return _pair("tiny", 11)


@pytest.fixture(scope="module")
def small_proxy():
    return _pair("tiny-proxy", 5)


@pytest.fixture(scope="module")
def batch():
    return ChainTask().serve_batch(np.random.default_rng(7), 6)


def _monitor(cls_mon, cls_stop, probe, delta):
    return cls_mon(stopper=cls_stop(alpha=0.2, delta=delta),
                   probe=probe(Tokens.END_THINK, (Tokens.ANS,)),
                   schedule="every_n", every_n=4, min_evals=1)


def _ecfg(cls, sampler, cache, capacity=320, budget=24):
    return cls(max_reasoning_tokens=budget, capacity=capacity, pad_id=Tokens.PAD,
               end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
               eos_id=Tokens.EOS, chunk_len=8, sampler=sampler(greedy=True),
               cache=cache)


def _engine(model, *, kind="ring", delta=1e9, proxy=None, page_size=16):
    ecfg = _ecfg(EngineConfig, SamplerConfig,
                 CacheConfig(kind=kind, page_size=page_size, attn_impl="auto"))
    return ReasoningEngine(model, ecfg,
                           _monitor(ReasoningMonitor, EATStopper, make_probe, delta),
                           proxy=None if proxy is None else ProxyConfig(model=proxy))


def _serve(eng, b, **kw):
    return eng.serve(b["prompts"], b["prompt_len"], None, batch_size=BATCH,
                     max_tokens=24, answer_len=4, record_trace=True, **kw)


def _assert_overlap_equal(ref, out, *, last_bits=frozenset()):
    """Overlapped == sync: tokens, exits, slots, answers and the traces'
    counts exactly; the traces' variances bitwise, except those of the
    requests in ``last_bits``, which must differ, by a few float32 ulps at
    most (rtol 1e-6)."""
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        tag = r["request"]
        assert (r["n_reasoning"], r["exit_reason"], r["ended_think"], r["slot"],
                r["status"]) == (o["n_reasoning"], o["exit_reason"],
                                 o["ended_think"], o["slot"], o["status"]), tag
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
        np.testing.assert_array_equal(r["answer_tokens"], o["answer_tokens"])
        assert [e[:2] for e in r["eat_trace"]] == [e[:2] for e in o["eat_trace"]]
        assert o["latency_s"] > 0
        if tag not in last_bits:
            assert r["eat_trace"] == o["eat_trace"], tag
        else:
            assert r["eat_trace"] != o["eat_trace"], tag
            np.testing.assert_allclose([e[2] for e in o["eat_trace"]],
                                       [e[2] for e in r["eat_trace"]],
                                       rtol=1e-6, atol=0)


def _not_bitwise(ref, out) -> set:
    """The requests whose EAT traces differ between two serves."""
    return {r["request"] for r, o in zip(ref, out)
            if r["eat_trace"] != o["eat_trace"]}


# --------------------------------------------------- overlapped == sync, port
@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("tier", ["self", "proxy"])
@pytest.mark.parametrize("delta", [1e9, 0.0])
def test_overlap_equals_sync_matrix(gen, batch, kind, tier, delta):
    """Both caches, both monitor tiers (the proxy on the generator's own
    weights), both exit regimes (every request exits at its first
    evaluation, or runs to the budget)."""
    model = gen[2]
    eng = _engine(model, kind=kind, delta=delta,
                  proxy=model if tier == "proxy" else None)
    ref = _serve(eng, batch)
    out = _serve(eng, batch, overlap=True)
    _assert_overlap_equal(ref, out)
    assert eng._ledger.quiescent
    st = eng.overlap_stats
    assert st["chunks"] > 0
    if kind == "paged":
        assert st["pages_deferred"] > 0
    if delta == 1e9:
        # every cohort exits inside its chunk: the next chunk flies all idle
        exits = {r["exit_reason"] for r in out}
        assert exits == {"eat"} and all(r["n_reasoning"] < 24 for r in out)
        if tier == "self":
            assert st["idle_chunks"] > 0


def test_ssm_overlap_equals_sync(batch):
    """``tiny-ssm`` through the ring: the recurrent state has no slot
    offsets, so the whole result is bitwise, traces included."""
    model = _pair("tiny-ssm", 3)[2]
    eng = _engine(model, delta=0.0)
    ref = _serve(eng, batch)
    out = _serve(eng, batch, overlap=True)
    _assert_overlap_equal(ref, out)
    assert len({r["slot"] for r in out}) < len(out)        # slots recycled


# ---------------------------------------------------------------- against JAX
def _jax_serve(gen, b, *, kind, delta, proxy=None, overlap=True):
    jmodel, params, _ = gen
    ecfg = _ecfg(JEngineConfig, JSampler,
                 JCache(kind=kind, page_size=16, attn_impl="xla"))
    pcfg = None if proxy is None else JProxyConfig(model=proxy[0], params=proxy[1])
    eng = JEngine(jmodel, params, ecfg, _monitor(JMonitor, JStopper, jprobe, delta),
                  proxy=pcfg)
    return eng.serve(b["prompts"], b["prompt_len"], jax.random.PRNGKey(0),
                     batch_size=BATCH, max_tokens=24, answer_len=4,
                     record_trace=True, overlap=overlap)


@pytest.mark.parametrize("kind,tier,delta", [("ring", "self", 0.0),
                                              ("paged", "proxy", 1e9)])
def test_overlap_matches_jax(gen, small_proxy, batch, kind, tier, delta):
    proxy = small_proxy if tier == "proxy" else None
    ref = _jax_serve(gen, batch, kind=kind, delta=delta, proxy=proxy)
    out = _serve(_engine(gen[2], kind=kind, delta=delta,
                         proxy=None if proxy is None else proxy[2]),
                 batch, overlap=True)
    assert len(out) == len(ref) == 6
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o["reasoning_tokens"],
                                      np.asarray(r["reasoning_tokens"]))
        assert (o["n_reasoning"], o["exit_reason"], o["ended_think"]) == \
               (r["n_reasoning"], r["exit_reason"], r["ended_think"])
        np.testing.assert_array_equal(o["answer_tokens"],
                                      np.asarray(r["answer_tokens"]))
        assert [e[:2] for e in o["eat_trace"]] == [e[:2] for e in r["eat_trace"]]
        np.testing.assert_allclose([e[2] for e in o["eat_trace"]],
                                   [e[2] for e in r["eat_trace"]],
                                   atol=1e-5, rtol=1e-4)
    if tier == "proxy":
        assert "eat" in {o["exit_reason"] for o in out}


# ------------------------------------------------------------- ring offsets
def _padded(b, pad):
    return dict(b, prompts=np.pad(b["prompts"], ((0, 0), (pad, 0)),
                                  constant_values=Tokens.PAD))


def test_sync_loop_variances_depend_on_page_offset(gen, batch):
    """The sync loop alone: left-padding every prompt moves each request's
    keys along the ring, and the attention folds them by page blocks of
    16 slots.  Half a page later, the variances change in their last bits
    (every token the same); a whole page later, nothing changes."""
    eng = _engine(gen[2], delta=0.0)
    ref = _serve(eng, batch)
    half = _serve(eng, _padded(batch, 8))
    _assert_overlap_equal(ref, half, last_bits=_not_bitwise(ref, half))
    assert _not_bitwise(ref, half)
    _assert_overlap_equal(ref, _serve(eng, _padded(batch, 16)))


@pytest.fixture(scope="module")
def mixed_exits_jax(gen, batch):
    """The JAX package's sync and overlapped serves at delta 4.45."""
    return [_jax_serve(gen, batch, kind="ring", delta=4.45, overlap=o)
            for o in (False, True)]


def test_overlap_behind_a_running_chunk(gen, batch, mixed_exits_jax):
    """delta 4.45 (far from every variance): requests exit at their 2nd
    or 3rd evaluation, so the pipeline admits requests behind a chunk that
    still runs, and they decode a part of a page later than in the sync
    loop.  Everything is the sync serve's exactly but those requests'
    variances, which differ in their last bits: in the same requests as
    the JAX package's overlapped serve differs from its sync serve."""
    jref, jout = mixed_exits_jax
    moved = _not_bitwise(jref, jout)
    assert moved and not moved & set(range(BATCH))    # admitted requests only
    eng = _engine(gen[2], delta=4.45)
    ref = _serve(eng, batch)
    assert len({r["n_reasoning"] for r in ref}) > 1   # mixed exits
    _assert_overlap_equal(ref, _serve(eng, batch, overlap=True),
                          last_bits=moved)


# ------------------------------------------------- forced adversarial schedules
class EagerBlockHooks(PipelineHooks):
    """Harvest before dispatch: wait on every snapshot as it is dispatched,
    so boundary F is on the host before the loop moves on."""

    def __init__(self):
        self.blocked = 0

    def on_dispatch(self, fence, snap):
        snap.wait()
        self.blocked += 1


class RecorderHooks(PipelineHooks):
    """Record the pipeline's event order."""

    def __init__(self):
        self.events = []

    def on_dispatch(self, fence, snap):
        self.events.append(("dispatch", fence))

    def on_retire(self, fence):
        self.events.append(("retire", fence))

    def on_observe(self, fence, pstate):
        self.events.append(("observe", fence))

    def on_retract(self, fence):
        self.events.append(("retract", fence))

    def on_harvest(self, fence, slots):
        self.events.append(("harvest", fence, tuple(slots)))

    def on_admit(self, fence, slot):
        self.events.append(("admit", fence, slot))

    def index(self, ev):
        return self.events.index(ev)


@pytest.mark.parametrize("kind,tier", [("ring", "self"), ("paged", "proxy")])
def test_harvest_before_dispatch_degenerate(gen, batch, kind, tier):
    model = gen[2]
    eng = _engine(model, kind=kind, proxy=model if tier == "proxy" else None)
    ref = _serve(eng, batch)
    hooks = EagerBlockHooks()
    out = _serve(eng, batch, overlap=True, pipeline_hooks=hooks)
    _assert_overlap_equal(ref, out)
    assert hooks.blocked > 1


def test_default_schedule_is_dispatch_ahead(gen, batch):
    eng = _engine(gen[2], kind="paged")
    hooks = RecorderHooks()
    _serve(eng, batch, overlap=True, pipeline_hooks=hooks)
    ev = hooks.events
    dispatched = [e[1] for e in ev if e[0] == "dispatch"]
    retired = [e[1] for e in ev if e[0] == "retire"]
    assert retired == sorted(dispatched)
    for f in retired:
        if ("dispatch", f + 1) in ev:
            assert hooks.index(("dispatch", f + 1)) < hooks.index(("retire", f))
    assert [e for e in ev if e[0] == "harvest" and ("dispatch", e[1] + 1) in ev]
    # admissions land while a later chunk flies, never into its snapshot
    admits = [e for e in ev if e[0] == "admit"]
    assert admits and all(("dispatch", e[1]) in ev for e in admits)


def test_proxy_reconciliation_lags_one_boundary(gen, batch):
    eng = _engine(gen[2], delta=0.0, proxy=gen[2])
    hooks = RecorderHooks()
    _serve(eng, batch, overlap=True, pipeline_hooks=hooks)
    ev = hooks.events
    observed = [e[1] for e in ev if e[0] == "observe"]
    assert observed
    for f in observed:
        if ("dispatch", f + 1) in ev:
            assert hooks.index(("dispatch", f + 1)) < hooks.index(("observe", f))
            assert hooks.index(("dispatch", f + 1)) < hooks.index(("retract", f))
        if ("retire", f + 1) in ev:
            assert hooks.index(("retract", f)) < hooks.index(("retire", f + 1))
    # a boundary whose chunk emitted nothing is not shadowed
    retired = [e[1] for e in ev if e[0] == "retire"]
    skipped = eng.overlap_stats["shadows_skipped"]
    assert len(observed) + skipped == len(retired)


def test_retract_overshoot_spans_page_boundary(gen, batch):
    """Page size 4 with chunk 8: every chunk spans two pages, so the lagged
    rewind of a proxy-stopped row crosses a page edge."""
    model = gen[2]
    eng = _engine(model, kind="paged", proxy=model, page_size=4)
    ref = _serve(eng, batch)
    out = _serve(eng, batch, overlap=True)
    _assert_overlap_equal(ref, out)
    assert all(r["exit_reason"] == "eat" for r in out)


class FenceGuardHooks(PipelineHooks):
    """At every harvest while a chunk flies, the freed rows' pages are
    parked on the ledger: neither free nor owned by any row."""

    def __init__(self, engine):
        self.engine = engine
        self.in_flight_harvests = 0
        self.alloc = None

    def on_harvest(self, fence, slots):
        led = self.engine._ledger
        if not led.in_flight:
            return
        self.in_flight_harvests += 1
        assert led._pending
        for _, alloc, pages in led._pending:
            self.alloc = alloc
            owned = {p for row in alloc._owned for p in row}
            for p in pages:
                assert p not in alloc.free and p not in owned


def test_freed_pages_wait_for_in_flight_fence(gen, batch):
    eng = _engine(gen[2], kind="paged", delta=0.0)
    hooks = FenceGuardHooks(eng)
    _serve(eng, batch, overlap=True, pipeline_hooks=hooks)
    assert hooks.in_flight_harvests > 0
    assert eng._ledger.pages_deferred > 0 and eng._ledger.quiescent
    assert hooks.alloc.pages_reused > 0
    assert hooks.alloc.pages_in_use == 0


class AdmitTraceHooks(PipelineHooks):
    """The (fence, slot) of every admission."""

    def __init__(self):
        self.admitted = []

    def on_admit(self, fence, slot):
        self.admitted.append((fence, slot))


def test_mid_serve_admissions_read_no_stale_row(gen):
    """Ten requests through two slots, exits at the first evaluation:
    nearly every boundary admits while the next chunk flies, so every
    snapshot holds rows of previous occupants.  The traces, recorded one
    boundary late, are the sync loop's bitwise (no entry from a previous
    occupant, no entry missing), and so is everything else."""
    b = ChainTask().serve_batch(np.random.default_rng(9), 10)
    eng = _engine(gen[2], kind="paged")
    kw = dict(batch_size=2, max_tokens=24, answer_len=4, record_trace=True)
    ref = eng.serve(b["prompts"], b["prompt_len"], None, **kw)
    hooks = AdmitTraceHooks()
    out = eng.serve(b["prompts"], b["prompt_len"], None, overlap=True,
                    pipeline_hooks=hooks, **kw)
    assert len(hooks.admitted) == 8
    _assert_overlap_equal(ref, out)
    for r in out:
        assert r["eat_trace"] and r["eat_trace"][0][0] > 1


# ---------------------------------------------------------------- launcher
def test_serve_cli_overlap_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
           "--arch", "tiny", "--batch", "2", "--cache", "paged",
           "--attn-impl", "auto", "--budget", "16"]
    r = subprocess.run(cmd + ["--requests", "6", "--overlap", "on"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "served 6 requests through 2 slots on cpu (monitor=self), " \
           "overlapped loop" in r.stdout
    r = subprocess.run(cmd + ["--overlap", "on"], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode != 0 and "--requests" in r.stderr
