"""The body the card's chunk graphs capture, pinned on the CPU
(``Executor.masked_chunk``, ``ProxyExecutor.masked_observe``).

* Masked == guarded: ``chunk_len`` steps with no branch, each masked by
  ``live`` on the device and probing every step (``probe_cond=False``),
  leave the state bitwise as the guarded loop that breaks at the first
  false guard: tokens, every ``ServeState`` and monitor field, the debiased
  variance's bits, ``steps``, and the whole cache (``pos``, K/V or SSM
  states, ``cur``).  Ring, a ring whose commits wrap inside the chunk onto
  live prompt slots, paged, ``tiny-ssm``, and the proxy's shadow chunk over
  ring and paged caches; in each, every row stops inside the chunk.
* Masked serves: whole serves with every chunk run as the masked body give
  the eager serves' tokens, exits, slots, answers and EAT traces bitwise.
* ``probe_cond=False`` against the JAX reference's ``make_eat_step(...,
  probe_cond=False)`` on ``tiny`` with the same params: greedy tokens and
  exits exact, the EAT traces to 1e-5.
* The executor keeps its serving caches and page-list buffers: a second
  serve on the same engine runs on the same tensors and gives the first
  serve's results.  An admission's prefill gets a cache of its own: a ring
  serve through one slot keeps the JAX engine's ``cur`` chunk by chunk.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.core.eat import make_probe as jprobe
from repro.core.monitor import ReasoningMonitor as JMonitor
from repro.core.stopping import EATStopper as JStopper
from repro.data.synthetic import ChainTask, Tokens
from repro.models import Model as JModel
from repro.serving.cache import CacheConfig as JCache
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReasoningEngine as JEngine
from repro.serving.executor import make_eat_step as jmake_eat_step
from repro.serving.proxy import ProxyConfig as JProxyConfig
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.models.model import Model, init_params
from repro_torch.params import from_jax
from repro_torch.serving import device_loop
from repro_torch.serving.cache import CacheConfig, cache_leaves
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.proxy import ProxyConfig
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import SlotScheduler

from _torch_threads import _one_thread  # noqa: F401


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


def _engine(model, *, kind="ring", delta=1e9, every_n=3, min_evals=2,
            budget=24, chunk=12, capacity=96, proxy=None):
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


def _assert_bitwise(ex, a, b):
    """Every tensor of two states (caches included) and their snapshots'
    debiased variance bits, equal."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)
    sa, sb = ex.snapshot(a), ex.snapshot(b)
    assert sa.var.view(np.int32).tolist() == sb.var.view(np.int32).tolist()
    assert sa.steps == sb.steps and sa.cur == sb.cur


# case -> (model, cache kind, ring slots past the prompt or None for the
# serve's capacity, engine kwargs)
CASES = {
    # every row exits by EAT at its 2nd evaluation (6th token), mid-chunk
    "ring": ("tiny", "ring", None, {}),
    "paged": ("tiny", "paged", None, {}),
    "ssm": ("tiny-ssm", "ring", None, {}),
    # every row runs to a budget of 8 at step 7 of 12, and the ring of
    # S + 4 slots wraps at step 5: the commits of steps 5-6 and the masked
    # steps 7-11 land on live prompt slots
    "ring-wrap": ("tiny", "ring", 4, dict(delta=0.0, budget=8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_decode_chunk_equals_the_guarded_loop(tiny, tiny_ssm, batch, case):
    name, kind, extra_slots, kw = CASES[case]
    model = tiny_ssm if name == "tiny-ssm" else tiny[2]
    eng = _engine(model, kind=kind, **kw)
    ex = eng.executor
    if extra_slots is None:
        ss = _setup(eng, batch)
        state, budget, chunk = ss.state, ss.budget, ss.chunk
    else:
        prompts, plen = batch["prompts"][:4], batch["prompt_len"][:4]
        C = prompts.shape[1] + extra_slots
        state = eng.start(prompts, plen, None, capacity=C)
        budget, chunk = eng.ecfg.max_reasoning_tokens, eng.ecfg.chunk_len
    calls = device_loop.device_if.calls
    ref = ex.decode_chunk(_copy(state), budget, chunk)
    steps = ex.snapshot(ref).steps
    assert 0 < steps < chunk and not bool(ref.active.any())
    assert device_loop.device_if.calls > calls
    calls = device_loop.device_if.calls
    out = ex.masked_chunk(state, budget, chunk)
    assert device_loop.device_if.calls == calls       # no host read
    _assert_bitwise(ex, ref, out)
    if extra_slots is not None:
        assert int(out.cache["cur"]) > out.cache["pos"].shape[1]


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_masked_shadow_chunk_equals_the_guarded_loop(tiny, batch, kind):
    """Rows consumed 5, 3, 1 and 0 tokens of the generator's chunk, and the
    proxy stops some of them: the masked shadow chunk equals the guarded
    one bitwise, the proxy cache's ``cur`` included."""
    eng = _engine(tiny[2], kind=kind, every_n=2, proxy=tiny[2])
    ss = _setup(eng, batch)
    gen = eng.executor.decode_chunk(ss.state, ss.budget, ss.chunk,
                                    use_monitor=False)
    n_start = ss.state.out_len
    ss.ptier.begin_chunk(ss.chunk, [0, 1, 2, 3])
    pstate, toks = ss.ptier.state, gen.out_tokens
    n_emitted = torch.tensor([5, 3, 1, 0])
    ex = eng.proxy_executor
    ref = ex.observe_chunk(_copy(pstate), toks, n_start, n_emitted, ss.chunk)
    steps = ex.snapshot(ref).steps
    assert 0 < steps < ss.chunk and bool(ref.monitor.stop_flag.any())
    out = ex.masked_observe(pstate, toks, n_start.long(), n_emitted, ss.chunk)
    _assert_bitwise(ex, ref, out)


def _masked_serves(monkeypatch, eng):
    """Every chunk of ``eng``'s serves run as the masked body."""
    ex = eng.executor
    monkeypatch.setattr(ex, "decode_chunk", lambda st, budget, chunk, **kw:
                        ex.masked_chunk(st, budget, chunk,
                                        use_monitor=kw.get("use_monitor", True)))
    if eng.proxy_executor is not None:
        px = eng.proxy_executor

        def observe(st, toks, n_start, n_emitted, chunk, **kw):
            return px.masked_observe(st, toks, torch.as_tensor(n_start).long(),
                                     torch.as_tensor(n_emitted).long(), chunk)

        monkeypatch.setattr(px, "observe_chunk", observe)


@pytest.mark.parametrize("name,kind,proxy", [
    ("tiny", "ring", False), ("tiny", "paged", False), ("tiny", "paged", True),
    ("tiny-ssm", "ring", False)])
def test_masked_serves_equal_the_eager_serves(monkeypatch, tiny, tiny_ssm, batch,
                                              name, kind, proxy):
    """6 requests through 4 slots (EAT exits mid-chunk, admissions between
    chunks, forced answers): the serve whose every chunk is the masked body
    gives the eager serve's results bitwise."""
    model = tiny_ssm if name == "tiny-ssm" else tiny[2]
    kw = dict(kind=kind, chunk=8, proxy=model if proxy else None)
    ref = _engine(model, **kw).serve(batch["prompts"], batch["prompt_len"], None,
                                     batch_size=4, answer_len=2, record_trace=True)
    eng = _engine(model, **kw)
    _masked_serves(monkeypatch, eng)
    out = eng.serve(batch["prompts"], batch["prompt_len"], None, batch_size=4,
                    answer_len=2, record_trace=True)
    assert "eat" in {r["exit_reason"] for r in ref}
    assert len({r["slot"] for r in ref}) < len(ref)
    for a, b in zip(ref, out):
        for key in ("n_reasoning", "exit_reason", "slot", "eat_trace"):
            assert a[key] == b[key]
        np.testing.assert_array_equal(a["reasoning_tokens"], b["reasoning_tokens"])
        np.testing.assert_array_equal(a["answer_tokens"], b["answer_tokens"])


def test_probe_every_step_matches_jax(tiny, batch):
    """The port's masked chunk (``make_eat_step(probe_cond=False)``) against
    the reference's every-step EAT step on the same params, chunk by chunk,
    with probes due every 3 tokens and EAT exits at the 2nd evaluation."""
    jmodel, params, model = tiny
    prompts, plen = batch["prompts"][:4], batch["prompt_len"][:4]
    budget, chunk = 24, 8
    C = prompts.shape[1] + budget
    kw = dict(max_reasoning_tokens=budget, capacity=C, pad_id=Tokens.PAD,
              end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
              eos_id=Tokens.EOS, chunk_len=chunk)
    jmon = JMonitor(stopper=JStopper(alpha=0.2, delta=1e9),
                    probe=jprobe(Tokens.END_THINK, (Tokens.ANS,)),
                    schedule="every_n", every_n=3, min_evals=2)
    jsampler = JSampler(greedy=True)
    jeng = JEngine(jmodel, params, JEngineConfig(
        sampler=jsampler, cache=JCache(kind="ring", page_size=16, attn_impl="xla"),
        **kw), jmon)
    jstep = jmake_eat_step(jmodel, jmon, jsampler, probe_cond=False)
    jadvance = jax.jit(lambda p, s: jeng.executor._advance(p, s, budget, jstep))
    eng = _engine(model, budget=budget, chunk=chunk, capacity=C)
    js = jeng.start(jnp.asarray(prompts), jnp.asarray(plen),
                    jax.random.PRNGKey(0), capacity=C)
    ts = eng.start(prompts, plen, None, capacity=C)
    for _ in range(budget):
        for _ in range(chunk):
            if not bool(jnp.any(js.active)):
                break
            js = jadvance(params, js)
        ts = eng.executor.masked_chunk(ts, budget, chunk)
        snap = eng.executor.snapshot(ts)
        assert snap.cur == int(js.cache["cur"])
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
    assert not snap.active.any() and snap.stop_flag.all()


@pytest.mark.parametrize("name,kind", [("tiny", "ring"), ("tiny", "paged"),
                                       ("tiny-ssm", "ring")])
def test_second_serve_reuses_the_cache_tensors(tiny, tiny_ssm, batch, name, kind):
    """A second serve on the same engine starts from the first serve's cache
    tensors, emptied in place, and gives the first serve's results."""
    model = tiny_ssm if name == "tiny-ssm" else tiny[2]
    eng = _engine(model, kind=kind, chunk=8)
    seen = []
    chunk = eng.executor.decode_chunk

    def watched(state, *a, **kw):
        seen.append([t.data_ptr() for t in cache_leaves(state.cache)])
        return chunk(state, *a, **kw)

    eng.executor.decode_chunk = watched
    runs = [eng.serve(batch["prompts"], batch["prompt_len"], None, batch_size=4,
                      answer_len=2, record_trace=True) for _ in range(2)]
    n = len(seen) // 2
    assert len(seen) == 2 * n and seen[0] == seen[n]
    for a, b in zip(*runs):
        assert a["eat_trace"] == b["eat_trace"] and a["slot"] == b["slot"]
        np.testing.assert_array_equal(a["reasoning_tokens"], b["reasoning_tokens"])
        np.testing.assert_array_equal(a["answer_tokens"], b["answer_tokens"])


def test_page_list_buffers_are_kept_per_bucket_width(tiny, batch):
    """``put_page_table`` copies into the cache's page table and into one
    page-list buffer per bucket width: a width that comes back gets its
    first buffer again."""
    eng = _engine(tiny[2], kind="paged")
    ss = _setup(eng, batch)
    ex, cache = eng.executor, ss.state.cache
    table = cache["page_table"]
    w0 = cache["blocks"]["pages"]
    B, NB = table.shape

    def blocks(width):
        z = np.zeros((B, width), np.int32)
        return z, z, np.zeros((B,), np.int32)

    ex.put_page_table(ss.state, ss.alloc.table, blocks(w0.shape[1] + 4))
    w1 = cache["blocks"]["pages"]
    assert w1.shape[1] == w0.shape[1] + 4
    ex.put_page_table(ss.state, ss.alloc.table, blocks(w0.shape[1]))
    assert cache["blocks"]["pages"] is w0 and cache["page_table"] is table
    assert not bool(w0.any())


@pytest.mark.parametrize("proxy", [False, True])
def test_ring_serve_through_one_slot_keeps_the_reference_cur(tiny, batch, proxy):
    """3 requests through 1 ring slot: an admission prefills into a cache
    of its own and merges it into the serving cache, whose ``cur`` becomes
    max(cur, S) as in the reference.  At the start of every chunk ``cur``
    equals the JAX engine's (the generator's and, in proxy mode with the
    same weights, the proxy tier's), and so do tokens, exits and EAT
    traces."""
    jmodel, params, model = tiny
    prompts, plen = batch["prompts"][:3], batch["prompt_len"][:3]
    S, budget, chunk = prompts.shape[1], 12, 4
    C = SlotScheduler.required_capacity(S, 3, 1, budget)
    jeng = JEngine(jmodel, params, JEngineConfig(
        max_reasoning_tokens=budget, capacity=C, pad_id=Tokens.PAD,
        end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
        eos_id=Tokens.EOS, chunk_len=chunk, sampler=JSampler(greedy=True),
        cache=JCache(kind="ring", page_size=16, attn_impl="xla")),
        JMonitor(stopper=JStopper(alpha=0.2, delta=1e9),
                 probe=jprobe(Tokens.END_THINK, (Tokens.ANS,)),
                 schedule="every_n", every_n=3, min_evals=2),
        proxy=JProxyConfig(model=jmodel, params=params) if proxy else None)
    eng = _engine(model, budget=budget, chunk=chunk, capacity=C,
                  proxy=model if proxy else None)
    curs = {}

    def watch(ex, op, name, state_of):
        chunk_fn = getattr(ex, op)
        curs[name] = []

        def watched(*a, **kw):
            curs[name].append(int(state_of(*a).cache["cur"]))
            return chunk_fn(*a, **kw)

        setattr(ex, op, watched)

    watch(jeng.executor, "decode_chunk", "jax", lambda params, st, *a: st)
    watch(eng.executor, "decode_chunk", "torch", lambda st, *a: st)
    if proxy:
        watch(jeng.proxy_executor, "observe_chunk", "jax proxy",
              lambda params, st, *a: st)
        watch(eng.proxy_executor, "observe_chunk", "torch proxy",
              lambda st, *a: st)
    ref = jeng.serve(prompts, plen, jax.random.PRNGKey(0), batch_size=1,
                     max_tokens=budget, record_trace=True)
    out = eng.serve(prompts, plen, None, batch_size=1, max_tokens=budget,
                    record_trace=True)
    assert {r["slot"] for r in out} == {0} and len(out) == 3
    assert curs["torch"] == curs["jax"]
    assert max(curs["torch"]) > S + budget       # cur outgrew a single prompt
    if proxy:
        assert curs["torch proxy"] == curs["jax proxy"]
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o["reasoning_tokens"],
                                      np.asarray(r["reasoning_tokens"]))
        assert (o["n_reasoning"], o["exit_reason"]) == (r["n_reasoning"],
                                                        r["exit_reason"])
        assert [e[:2] for e in o["eat_trace"]] == [e[:2] for e in r["eat_trace"]]
