"""The port's decode chunk and proxy shadow chunk as the reference's
one-dispatch chunk, on the CPU (``serving/device_loop.py``,
``Executor.decode_chunk`` / ``ProxyExecutor.observe_chunk`` /
``Executor.snapshot``).

* No host read in a chunk: while one chunk runs, every host read of device
  data (``aten._local_scalar_dense``, ``aten.nonzero``) is a
  ``device_if`` predicate, for the decode step with its lazy probe (ring,
  paged and the Mamba2 state) and for the proxy's shadow step.
* Early stop: ``chunk_len`` masked steps (no predicate read, as the chunk
  graph the device runs alone) give the break loop's state bitwise when
  rows exit inside the chunk, and in the shadow loop when rows consumed
  different counts.
* The device ``cur`` against the JAX engine: chunk by chunk over a ring whose
  last probes wrap onto slot 0, the same tokens, exits, evaluation counts
  and ``cur``; the EMA variance within the float32 bar of
  tests/test_torch_serve.py (atol 1e-5, rtol 1e-4).
* Host mirror and snapshot: one device-to-host snapshot per chunk (and one
  per shadow chunk); its fields equal the live state's, and the host's
  mirror (the snapshot, updated at each admission) equals the device state
  each time a chunk starts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_config as jget
from repro.core.eat import make_probe as jprobe
from repro.core.monitor import ReasoningMonitor as JMonitor
from repro.core.stopping import EATStopper as JStopper
from repro.data.synthetic import ChainTask, Tokens
from repro.models import Model as JModel
from repro.serving.cache import CacheConfig as JCache
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReasoningEngine as JEngine
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.models.model import Model, init_params
from repro_torch.params import from_jax
from repro_torch.serving import device_loop
from repro_torch.serving.cache import CacheConfig
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.proxy import ProxyConfig
from repro_torch.serving.sampler import SamplerConfig

from _torch_threads import _one_thread  # noqa: F401


HOST_READS = {torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default}


class HostReads(TorchDispatchMode):
    """Counts the ops that read device data on the host."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in HOST_READS
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny model and params, and the port's model on them."""
    jmodel = JModel(jget("tiny"), attn_impl="xla")
    params = jmodel.init(jax.random.PRNGKey(11))
    cfg = get_config("tiny")
    return jmodel, params, Model(cfg, from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg, "cpu"))


@pytest.fixture(scope="module")
def tiny_ssm():
    cfg = get_config("tiny-ssm")
    return Model(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"))


@pytest.fixture(scope="module")
def batch():
    return ChainTask().serve_batch(np.random.default_rng(7), 6)


def _engine(model, *, kind="ring", delta=1e9, every_n=2, min_evals=1,
            budget=24, chunk=8, capacity=96, proxy=None):
    ecfg = EngineConfig(
        max_reasoning_tokens=budget, capacity=capacity, pad_id=Tokens.PAD,
        end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
        eos_id=Tokens.EOS, chunk_len=chunk, sampler=SamplerConfig(greedy=True),
        cache=CacheConfig(kind=kind, page_size=16, attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=delta),
                           probe=make_probe(Tokens.END_THINK, (Tokens.ANS,)),
                           schedule="every_n", every_n=every_n,
                           min_evals=min_evals)
    return ReasoningEngine(model, ecfg, mon,
                           proxy=None if proxy is None else ProxyConfig(model=proxy))


def _setup(eng, b, n=4):
    return eng._serve_setup(b["prompts"][:n], b["prompt_len"][:n], None,
                            batch_size=n, max_tokens=eng.ecfg.max_reasoning_tokens,
                            chunk_len=eng.ecfg.chunk_len)


def _copy(tree):
    """A copy of every tensor of a state (its cache too)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_copy(v) for v in tree))
    return tree


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _shadow_inputs(eng, ss):
    """The proxy tier's state and one generator chunk to shadow: (state,
    generator tokens, n_start, n_emitted) as the serve loop passes them."""
    gen = eng.executor.decode_chunk(ss.state, ss.budget, ss.chunk,
                                    use_monitor=False)
    n_start = ss.state.out_len
    ss.ptier.begin_chunk(ss.chunk, list(range(len(n_start))))
    return ss.ptier.state, gen.out_tokens, n_start, gen.out_len - n_start


# ------------------------------------------------------------ host reads
@pytest.mark.parametrize("op,kind", [("decode", "ring"), ("decode", "paged"),
                                     ("decode", "ssm"), ("shadow", "ring"),
                                     ("shadow", "paged")])
def test_chunk_reads_the_host_only_through_device_if(tiny, tiny_ssm, batch, op,
                                                      kind):
    """One chunk with probes due (every 2 tokens): the host reads device
    data exactly once per ``device_if`` call, which is one per step guard
    and one per lazy-probe decision."""
    model = tiny_ssm if kind == "ssm" else tiny[2]
    eng = _engine(model, kind="ring" if kind == "ssm" else kind, delta=0.0,
                  proxy=tiny[2] if op == "shadow" else None)
    ss = _setup(eng, batch)
    if op == "decode":
        state = ss.state
        run = lambda: eng.executor.decode_chunk(state, ss.budget, ss.chunk)  # noqa: E731
    else:
        pstate, toks, n_start, n_emitted = _shadow_inputs(eng, ss)
        state = pstate
        run = lambda: eng.proxy_executor.observe_chunk(  # noqa: E731
            pstate, toks, n_start, n_emitted, ss.chunk)
    evals = state.monitor.n_evals.clone()
    calls = device_loop.device_if.calls
    with HostReads() as reads:
        out = run()
    calls = device_loop.device_if.calls - calls
    assert reads.n == calls
    # every step ran (delta 0: no EAT exit), each with a guard and a probe
    # decision, and the probe fired
    assert calls == 2 * ss.chunk
    assert bool((out.monitor.n_evals > evals).any())


# ------------------------------------------------------------ early stop
@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_guarded_decode_steps_equal_the_break_loop(tiny, batch, kind):
    """Every row exits at its second evaluation, inside the chunk: the
    chunk_len masked steps (``masked_chunk``, the chunk graph's body) leave
    the cache, ``cur``, tokens and monitor state bitwise as the loop that
    breaks at the first false guard."""
    eng = _engine(tiny[2], kind=kind, delta=1e9, every_n=3, min_evals=2,
                  chunk=12)
    ss = _setup(eng, batch)
    ex = eng.executor
    ref = ex.decode_chunk(_copy(ss.state), ss.budget, ss.chunk)
    steps = ex.snapshot(ref).steps
    calls = device_loop.device_if.calls
    out = ex.masked_chunk(ss.state, ss.budget, ss.chunk)
    assert 0 < steps < ss.chunk and ex.snapshot(out).steps == steps
    assert not bool(ref.active.any())
    # the masked steps read no guard
    assert device_loop.device_if.calls == calls
    _assert_states_equal(ref, out)
    assert int(out.cache["cur"]) == ss.snap.cur + steps


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_guarded_shadow_steps_equal_the_break_loop(tiny, batch, kind):
    """Rows consumed 5, 3, 1 and 0 tokens of the generator's chunk: the
    shadow's chunk_len masked steps (``masked_observe``) equal its break
    loop bitwise."""
    eng = _engine(tiny[2], kind=kind, delta=1e9, every_n=2, min_evals=2,
                  proxy=tiny[2])
    ss = _setup(eng, batch)
    pstate, toks, n_start, _ = _shadow_inputs(eng, ss)
    n_emitted = torch.tensor([5, 3, 1, 0])
    ex = eng.proxy_executor
    n0 = pstate.n_reasoning.clone()
    ref = ex.observe_chunk(_copy(pstate), toks, n_start, n_emitted, ss.chunk)
    steps = ex.snapshot(ref).steps
    out = ex.masked_observe(pstate, toks, n_start.long(), n_emitted, ss.chunk)
    assert 0 < steps < ss.chunk and ex.snapshot(out).steps == steps
    _assert_states_equal(ref, out)
    # a row consumed its tokens, or fewer where the proxy stopped it
    consumed, stop = out.n_reasoning - n0, out.monitor.stop_flag
    assert bool((consumed <= n_emitted).all()) and bool(stop.any())
    assert torch.equal(consumed[~stop], n_emitted[~stop])


# ------------------------------------------------------- device cur vs JAX
def test_device_cur_chunks_match_jax_through_a_ring_wrap(tiny, batch):
    """Chunk by chunk over a ring of S + budget slots with a probe after
    every token: the last probes write past the end, onto slot 0 (a prompt
    token), and both engines still agree on every token, exit and
    evaluation count, and on ``cur``."""
    jmodel, params, model = tiny
    prompts, plen = batch["prompts"][:4], batch["prompt_len"][:4]
    S, budget, chunk = prompts.shape[1], 16, 4
    C = S + budget
    kw = dict(max_reasoning_tokens=budget, capacity=C, pad_id=Tokens.PAD,
              end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
              eos_id=Tokens.EOS, chunk_len=chunk)
    jeng = JEngine(jmodel, params, JEngineConfig(
        sampler=JSampler(greedy=True),
        cache=JCache(kind="ring", page_size=16, attn_impl="xla"), **kw),
        JMonitor(stopper=JStopper(alpha=0.2, delta=0.0),
                 probe=jprobe(Tokens.END_THINK, (Tokens.ANS,)),
                 schedule="every_n", every_n=1, min_evals=1))
    eng = _engine(model, delta=0.0, every_n=1, budget=budget, chunk=chunk,
                  capacity=C)
    js = jeng.start(jnp.asarray(prompts), jnp.asarray(plen),
                    jax.random.PRNGKey(0), capacity=C)
    ts = eng.start(prompts, plen, None, capacity=C)
    wrapped = False
    for _ in range(budget):
        js = jeng.executor.decode_chunk(params, js, budget, chunk)
        ts = eng.executor.decode_chunk(ts, budget, chunk)
        snap = eng.executor.snapshot(ts)
        assert snap.cur == int(js.cache["cur"]) == int(ts.cache["cur"])
        wrapped |= snap.cur + len(eng.monitor.probe) > C
        for name in ("active", "n_reasoning", "out_len", "ended_think"):
            np.testing.assert_array_equal(getattr(snap, name),
                                          np.asarray(getattr(js, name)))
        np.testing.assert_array_equal(snap.tokens, np.asarray(js.out_tokens))
        np.testing.assert_array_equal(snap.n_evals, np.asarray(js.monitor.n_evals))
        np.testing.assert_array_equal(snap.stop_flag,
                                      np.asarray(js.monitor.stop_flag))
        jvar = jeng.monitor.stopper.debiased_var(js.monitor.stop_state)
        np.testing.assert_allclose(snap.var, np.asarray(jvar), atol=1e-5,
                                   rtol=1e-4)
        if not snap.active.any():
            break
    assert wrapped and not snap.active.any()
    assert (snap.n_reasoning == budget).any()


# ------------------------------------------------ host mirror and snapshot
def _live(state):
    return {"active": state.active.numpy(), "n_reasoning": state.n_reasoning.numpy(),
            "out_len": state.out_len.numpy(),
            "stop_flag": state.monitor.stop_flag.numpy(),
            "n_evals": state.monitor.n_evals.numpy()}


def _watch(ex, chunk_op, reads, chunks):
    """Wrap ``ex``: each snapshot is checked against the live state it
    copies; each chunk call checks the last snapshot — the host's mirror,
    amended at admissions — against the state the chunk starts from."""
    last = []
    snapshot, chunk = ex.snapshot, getattr(ex, chunk_op)

    def watched_snapshot(state):
        snap = snapshot(state)
        reads.append(1)
        for name, v in _live(state).items():
            np.testing.assert_array_equal(getattr(snap, name), v)
        np.testing.assert_array_equal(snap.ended_think, state.ended_think.numpy())
        np.testing.assert_array_equal(snap.tokens, state.out_tokens.numpy())
        np.testing.assert_array_equal(snap.var, ex.monitor.stopper.debiased_var(
            state.monitor.stop_state).numpy())
        assert snap.cur == int(state.cache["cur"])
        last[:] = [snap]
        return snap

    def watched_chunk(state, *a, **kw):
        chunks.append(1)
        mirror = last[0]
        assert mirror.cur == int(state.cache["cur"])
        for name, v in _live(state).items():
            np.testing.assert_array_equal(getattr(mirror, name), v)
        return chunk(state, *a, **kw)

    ex.snapshot = watched_snapshot
    setattr(ex, chunk_op, watched_chunk)


@pytest.mark.parametrize("kind,proxy", [("ring", False), ("paged", False),
                                        ("ring", True), ("paged", True)])
def test_snapshot_and_host_mirror_track_the_device(tiny, batch, kind, proxy):
    """6 requests through 4 slots (admissions between chunks): one
    snapshot read per chunk after the setup's, its fields the live
    state's, and the mirror equal to the device at every chunk start, for
    the generator and the proxy tier alike."""
    eng = _engine(tiny[2], kind=kind, delta=1e9, every_n=3, min_evals=2,
                  proxy=tiny[2] if proxy else None)
    watched = [(eng.executor, "decode_chunk")]
    if proxy:
        watched.append((eng.proxy_executor, "observe_chunk"))
    counts = []
    for ex, op in watched:
        reads, chunks = [], []
        _watch(ex, op, reads, chunks)
        counts.append((reads, chunks))
    out = eng.serve(batch["prompts"], batch["prompt_len"], None, batch_size=4,
                    answer_len=2, record_trace=True)
    assert {o["exit_reason"] for o in out} == {"eat"}
    assert len({o["slot"] for o in out}) < len(out)
    for reads, chunks in counts:
        assert len(chunks) >= 2 and len(reads) == len(chunks) + 1
