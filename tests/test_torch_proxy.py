"""The port's black-box proxy tier (``monitor_mode == "proxy"``) on the CPU
(the port's counterpart of tests/test_proxy_serve.py).

* Against JAX: the tiny generator monitored by ``tiny-proxy`` (and by
  ``tiny-ssm``, whose shadow step freezes inactive rows), both models'
  weights moved over by ``params.from_jax``, serves identical reasoning
  tokens, exit steps and reasons and forced answers through the ring and
  the paged cache; the EAT traces agree within float32 tolerance (atol
  1e-5, rtol 1e-4, the bar of tests/test_torch_serve.py).
* Inside the port: a proxy running the generator's own weights reproduces
  the port's self-EAT serve bit for bit; the generator's model never
  probes in proxy mode (the black-box contract); the proxy's page pool
  recycles pages on its own, gates admission with the generator's (each
  short pool counting its deferrals) and fails fast when it cannot hold one
  request; ``ProxyMonitor`` probes at the generator's stream offset; the
  launcher serves with ``--monitor proxy``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
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
from repro.serving.proxy import ProxyMonitor as JProxyMonitor
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.models.model import Model
from repro_torch.params import from_jax
from repro_torch.serving.cache import CacheConfig
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.proxy import ProxyConfig, ProxyMonitor
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import PageAllocator, admit_or_defer

from _torch_threads import _one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


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


def _ecfg(cls, sampler, cache, capacity, budget=24):
    return cls(max_reasoning_tokens=budget, capacity=capacity, pad_id=Tokens.PAD,
               end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
               eos_id=Tokens.EOS, chunk_len=8, sampler=sampler(greedy=True),
               cache=cache)


def _jax_serve(gen, proxy, b, *, kind, delta, capacity=320):
    jmodel, params, _ = gen
    pm, pp, _ = proxy
    ecfg = _ecfg(JEngineConfig, JSampler,
                 JCache(kind=kind, page_size=16, attn_impl="xla"), capacity)
    eng = JEngine(jmodel, params, ecfg, _monitor(JMonitor, JStopper, jprobe, delta),
                  proxy=JProxyConfig(model=pm, params=pp))
    return eng.serve(b["prompts"], b["prompt_len"], jax.random.PRNGKey(0),
                     batch_size=4, max_tokens=24, answer_len=4, record_trace=True)


def _engine(model, *, kind="ring", delta=1e9, proxy=None, capacity=320,
            num_pages=0, attn="auto"):
    ecfg = _ecfg(EngineConfig, SamplerConfig,
                 CacheConfig(kind=kind, page_size=16, num_pages=num_pages,
                             attn_impl=attn), capacity)
    return ReasoningEngine(model, ecfg,
                           _monitor(ReasoningMonitor, EATStopper, make_probe, delta),
                           proxy=proxy)


def _serve(eng, b, **kw):
    kw = {"answer_len": 4, "record_trace": True, **kw}
    return eng.serve(b["prompts"], b["prompt_len"], None, batch_size=4,
                     max_tokens=24, **kw)


def _assert_bit_equal(ref, out):
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        assert (r["n_reasoning"], r["exit_reason"], r["ended_think"], r["slot"]) == \
               (o["n_reasoning"], o["exit_reason"], o["ended_think"], o["slot"])
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
        np.testing.assert_array_equal(r["answer_tokens"], o["answer_tokens"])
        assert r["eat_trace"] == o["eat_trace"]


def _count_calls(obj, name):
    """Replace ``obj.name`` by a wrapper counting its calls; returns the
    one-element counter list."""
    n, fn = [0], getattr(obj, name)

    def counted(*a, **kw):
        n[0] += 1
        return fn(*a, **kw)

    setattr(obj, name, counted)
    return n


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("delta", [1e9, 0.2])
def test_small_proxy_serve_matches_jax(gen, small_proxy, batch, kind, delta):
    """tiny monitored by tiny-proxy: delta 1e9 exits every request at the
    proxy's first evaluation, 0.2 lets the traces run longer."""
    ref = _jax_serve(gen, small_proxy, batch, kind=kind, delta=delta)
    out = _serve(_engine(gen[2], kind=kind, delta=delta,
                         proxy=ProxyConfig(model=small_proxy[2])), batch)
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
    if delta == 1e9:
        assert all(o["exit_reason"] == "eat" and o["n_reasoning"] < 24 for o in out)


def test_ssm_proxy_serve_matches_jax(gen, batch):
    """A Mamba2 proxy (recurrent state, the freeze of invalid rows in the
    shadow step) monitoring the dense generator through the ring cache."""
    proxy = _pair("tiny-ssm", 5)
    ref = _jax_serve(gen, proxy, batch, kind="ring", delta=0.2)
    out = _serve(_engine(gen[2], kind="ring", delta=0.2,
                         proxy=ProxyConfig(model=proxy[2])), batch)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o["reasoning_tokens"],
                                      np.asarray(r["reasoning_tokens"]))
        assert (o["n_reasoning"], o["exit_reason"]) == (r["n_reasoning"], r["exit_reason"])
        np.testing.assert_allclose([e[2] for e in o["eat_trace"]],
                                   [e[2] for e in r["eat_trace"]],
                                   atol=1e-5, rtol=1e-4)


# ----------------------------------------------------------- inside the port
@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("delta", [1e9, 0.0])
def test_same_params_proxy_bit_exact_with_self_eat(gen, batch, kind, delta):
    """The acceptance A/B: a proxy running the generator's own weights gives
    the port's self-EAT serve exactly (tokens, exits, slots, answers, EAT
    traces as floats), exit-at-first-evaluation and run-to-budget."""
    model = gen[2]
    ref = _serve(_engine(model, kind=kind, delta=delta), batch)
    out = _serve(_engine(model, kind=kind, delta=delta,
                         proxy=ProxyConfig(model=model)), batch)
    _assert_bit_equal(ref, out)


def test_generator_never_probes_in_proxy_mode(gen, small_proxy, batch):
    """The black-box contract: no generator logits feed the exit decision.
    The generator's model runs no probe forward and its executor no
    monitored step; the probes all run on the proxy's model."""
    eng = _engine(gen[2], delta=1e9, proxy=ProxyConfig(model=small_proxy[2]))
    assert eng.monitor_mode == "proxy"
    gen_probes = _count_calls(eng.model, "probe_entropy")
    gen_steps = _count_calls(eng.executor, "_step_mon")
    proxy_probes = _count_calls(eng.proxy_executor.model, "probe_entropy")
    out = _serve(eng, batch)
    assert gen_probes[0] == 0 and gen_steps[0] == 0
    assert proxy_probes[0] > 0
    assert all(o["exit_reason"] == "eat" for o in out)
    # the audit's own sanity: a self-EAT serve does probe on the generator
    ref = _engine(gen[2], delta=1e9)
    assert ref.monitor_mode == "self"
    ref_probes = _count_calls(ref.model, "probe_entropy")
    _serve(ref, batch)
    assert ref_probes[0] > 0


def test_proxy_mode_refusals(gen, batch):
    """reason() has no prompt stream for the proxy and refuses to monitor
    (the unmonitored path stays); an SSM generator cannot be retracted."""
    model = gen[2]
    eng = _engine(model, proxy=ProxyConfig(model=model))
    st = eng.start(batch["prompts"][:2], batch["prompt_len"][:2])
    with pytest.raises(ValueError, match="serve"):
        eng.reason(st)
    st = eng.reason(eng.start(batch["prompts"][:2], batch["prompt_len"][:2]),
                    use_monitor=False, max_tokens=8)
    assert int(st.n_reasoning.min()) >= 8 or bool(st.ended_think.any())
    ssm = _pair("tiny-ssm", 1)[2]
    with pytest.raises(ValueError, match="SSM"):
        _engine(ssm, proxy=ProxyConfig(model=model))


def test_proxy_exit_frees_pages_for_same_batch_admissions(gen):
    """14 requests through a 13-data-page generator pool and a proxy pool
    of the same size: proxy-driven exits reclaim pages in both pools."""
    model = gen[2]
    b = ChainTask().serve_batch(np.random.default_rng(9), 14)
    eng = _engine(model, kind="paged", num_pages=14, capacity=640,
                  proxy=ProxyConfig(model=model))
    out = _serve(eng, b, answer_len=0, record_trace=False)
    assert len(out) == 14 and all(r["exit_reason"] == "eat" for r in out)
    assert eng._ptier.alloc.pages_reused > 0
    assert eng._ptier.alloc.peak_pages_in_use <= 13
    assert eng._ptier.state is None          # dropped after the serve


def test_undersized_proxy_pool_still_serves_queue(gen):
    """A ring generator (no page gate) with a small proxy pool: the proxy
    tier's harvest-time frees back the next admissions and the queue
    drains."""
    model = gen[2]
    b = ChainTask().serve_batch(np.random.default_rng(9), 14)
    eng = _engine(model, kind="ring", capacity=640, proxy=ProxyConfig(
        model=model, cache=CacheConfig(kind="paged", page_size=16, num_pages=14)))
    out = _serve(eng, b, answer_len=0, record_trace=False)
    assert len(out) == 14 and all(r["exit_reason"] == "eat" for r in out)
    assert eng._ptier.alloc.pages_reused > 0
    assert eng._ptier.alloc.peak_pages_in_use <= 13


def test_admission_gate_defers_on_the_short_pool_only():
    """The two-pool gate: all-or-nothing, and a refusal counts one deferral
    on each pool that is short (a ring pool, None, has no gate).  In the
    sync loop a harvest frees at least one admission's pages, so a queued
    request waits only where an earlier admission left a pool short."""
    gen_pool, proxy_pool = PageAllocator(8, 4, 16, 2), PageAllocator(6, 4, 16, 2)
    assert admit_or_defer(12, gen_pool, proxy_pool, None)   # needs 4 of 7 / 5
    proxy_pool.admit_row(0, 12, 12)                          # 1 proxy page left
    assert not admit_or_defer(12, gen_pool, proxy_pool)
    assert (gen_pool.deferrals, proxy_pool.deferrals) == (0, 1)
    proxy_pool.free_row(0)
    assert admit_or_defer(12, gen_pool, proxy_pool)


def test_proxy_pool_too_small_for_one_request_fails_fast(gen):
    model = gen[2]
    b = ChainTask().serve_batch(np.random.default_rng(9), 3)
    eng = _engine(model, kind="ring", capacity=640, proxy=ProxyConfig(
        model=model, cache=CacheConfig(kind="paged", page_size=4, num_pages=3)))
    with pytest.raises(RuntimeError, match="proxy|num_pages"):
        eng.serve(b["prompts"], b["prompt_len"], None, batch_size=2, max_tokens=24)


# ------------------------------------------------------------ ProxyMonitor
def test_proxy_monitor_probes_at_generator_offset(gen):
    """The standalone monitor: a drifted internal counter is overridden by
    the generator's ``next_pos``; the EATs agree with JAX's ProxyMonitor."""
    jmodel, params, model = gen
    b = ChainTask().serve_batch(np.random.default_rng(3), 2)
    chunk = np.random.default_rng(0).integers(4, 40, size=(2, 6)).astype(np.int32)
    mon = _monitor(ReasoningMonitor, EATStopper, make_probe, 1e-3)
    proxy = ProxyMonitor(model=model, monitor=mon, capacity=64)

    ref = proxy.observe_chunk(proxy.start(b["prompts"], b["prompt_len"]), chunk)
    ref_eat = ref["last_eat"].numpy()
    drifted = proxy.start(b["prompts"], b["prompt_len"])
    true_pos = drifted["next_pos"]
    drifted["next_pos"] = true_pos + 7
    out = proxy.observe_chunk(drifted, chunk, next_pos=true_pos)
    np.testing.assert_array_equal(out["last_eat"].numpy(), ref_eat)
    np.testing.assert_array_equal(out["next_pos"].numpy(), ref["next_pos"].numpy())
    bad = proxy.start(b["prompts"], b["prompt_len"])
    bad["next_pos"] = bad["next_pos"] + 7
    assert not np.array_equal(proxy.observe_chunk(bad, chunk)["last_eat"].numpy(),
                              ref_eat)

    jproxy = JProxyMonitor(model=jmodel, params=params, capacity=64,
                           monitor=_monitor(JMonitor, JStopper, jprobe, 1e-3))
    jst = jproxy.observe_chunk(jproxy.start(jnp.asarray(b["prompts"]),
                                            jnp.asarray(b["prompt_len"])),
                               jnp.asarray(chunk))
    np.testing.assert_allclose(ref_eat, np.asarray(jst["last_eat"]), atol=1e-5)


# ---------------------------------------------------------------- launcher
def test_serve_cli_proxy_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--monitor", "proxy", "--proxy-config", "tiny-proxy", "--arch", "tiny",
         "--requests", "4", "--batch", "2", "--budget", "16", "--chunk", "4",
         "--cache", "paged", "--attn-impl", "auto"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "served 4 requests through 2 slots on cpu (monitor=proxy)" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--monitor", "proxy", "--proxy-config", "mamba2-2.7b", "--arch", "tiny",
         "--requests", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and "vocab" in (r.stdout + r.stderr)
