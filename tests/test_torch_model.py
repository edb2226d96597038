"""The port's model against the JAX reference on the CPU: ``from_jax``
params, ``prefill`` / ``decode_step`` / ``probe_entropy`` on a 2-layer GQA
config with g = 4 (and the tied ``tiny-reasoner``), plus the invariants
JAX gets from purity and the port must keep by hand: a probe and a rollout
leave ``pos``, ``cur`` and every live slot's K/V bitwise unchanged.

Tolerances: 1e-4 on float32 full-forward hidden states, logits and
entropies; 1e-5 on the K/V a prefill writes (two float32 ops deep).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import get_config as jget
from repro.models import Model as JModel
from repro.serving.cache import alloc_cache as jalloc
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.configs.base import get_config as tget
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import init_params
from repro_torch.models.transformer import gather_pages
from repro_torch.params import from_jax
from repro_torch.serving.cache import CacheConfig, alloc_cache
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.sampler import SamplerConfig

G4 = dict(name="gqa4", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
          head_dim=16, d_ff=128, vocab=200, qk_norm=True, rope_theta=1e6,
          dtype="float32")


def _pair(name, jimpl, timpl):
    if name == "gqa4":
        jc, tc = JConfig(**G4), TConfig(**G4)
    else:
        jc, tc = jget(name), tget(name)
    jm = JModel(jc, attn_impl="xla", paged_attn_impl=jimpl)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tc, from_jax(jax.tree_util.tree_map(np.asarray, params), tc, "cpu"),
                paged_attn_impl=timpl)
    return jm, params, tm


def _prompts(B=2, S=12, vocab=200, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, vocab, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, :4] = -1                        # row 1 left-padded by 4
    pos[1, 4:] = np.arange(S - 4)
    toks[1, :4] = 0
    return toks, pos


def close(a, b, tol):
    np.testing.assert_allclose(a.detach().float().numpy(),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["gqa4", "tiny-reasoner"])
@pytest.mark.parametrize("impls", [("gather", "gather"), ("xla", "plain")])
def test_prefill_decode_probe_match_jax(name, impls):
    jm, params, tm = _pair(name, *impls)
    vocab = tm.cfg.vocab
    toks, pos = _prompts(vocab=vocab)
    jcache = jalloc(jm.cfg, 2, 32)
    tcache = alloc_cache(tm.cfg, 2, 32, device="cpu")
    jh, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(pos),
                            jnp.asarray(pos), jcache)
    th = tm.prefill(torch.from_numpy(toks).long(), torch.from_numpy(pos),
                    torch.from_numpy(pos), tcache)
    close(th, jh, 1e-4)
    assert tcache["cur"] == int(jcache["cur"]) == 12
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    for li, e in enumerate(tcache["layers"]):
        close(e["k"], jcache["layers"]["seg"]["k"][li], 1e-5)
        close(e["v"], jcache["layers"]["seg"]["v"][li], 1e-5)
    close(tm.logits(th[:, -1:]), jm.logits(params, jh[:, -1:]), 1e-4)

    nxt = np.array([[7], [9]], np.int32)
    p1 = np.array([[12], [8]], np.int32)
    jl, jcache = jm.decode_step(params, jnp.asarray(nxt), jnp.asarray(p1),
                                jnp.asarray(p1), jcache)
    tl = tm.decode_step(torch.from_numpy(nxt).long(), torch.from_numpy(p1),
                        torch.from_numpy(p1), tcache)
    close(tl, jl, 1e-4)

    probe = np.array([[1, 6]] * 2, np.int32)
    pp = p1 + 1 + np.arange(2, dtype=np.int32)[None]
    je = jm.probe_entropy(params, jnp.asarray(probe), jnp.asarray(pp),
                          jnp.asarray(pp), jcache, entropy_impl="xla")
    te = tm.probe_entropy(torch.from_numpy(probe).long(), torch.from_numpy(pp),
                          torch.from_numpy(pp), tcache)
    close(te, je, 1e-4)


def _live_snapshot(cache):
    """pos, cur and the K/V of every live (pos >= 0) slot, as the logical
    view (paged pools are read through the page table)."""
    pos = cache["pos"].clone()
    live = pos >= 0
    kv = []
    for e in cache["layers"]:
        for name in ("k", "v"):
            t = e[name]
            if "page_table" in cache:
                t = gather_pages(t, cache["page_table"])
            kv.append(t[live].clone())
    return pos, cache["cur"], kv


def _assert_unchanged(before, cache):
    pos, cur, kv = before
    assert torch.equal(cache["pos"], pos)
    assert cache["cur"] == cur
    for a, b in zip(kv, _live_snapshot(cache)[2]):
        assert torch.equal(a, b)


def test_probe_wrapping_the_ring_commits_nothing_and_matches_jax():
    """A probe near the end of the ring wraps onto slot 0 (a prompt token):
    the port gives JAX's answer (whose wrapped write lands in a discarded
    cache) and restores the live slot bit for bit."""
    jm, params, tm = _pair("gqa4", "xla", "plain")
    toks, pos = _prompts()
    jcache, tcache = jalloc(jm.cfg, 2, 16), alloc_cache(tm.cfg, 2, 16, device="cpu")
    _, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(pos),
                           jnp.asarray(pos), jcache)
    tm.prefill(torch.from_numpy(toks).long(), torch.from_numpy(pos),
               torch.from_numpy(pos), tcache)
    for step in range(3):                  # cur 12 -> 15
        tok = np.array([[5 + step], [6 + step]], np.int32)
        p1 = np.array([[12 + step], [8 + step]], np.int32)
        _, jcache = jm.decode_step(params, jnp.asarray(tok), jnp.asarray(p1),
                                   jnp.asarray(p1), jcache)
        tm.decode_step(torch.from_numpy(tok).long(), torch.from_numpy(p1),
                       torch.from_numpy(p1), tcache)
    assert tcache["cur"] == 15 and int(tcache["pos"][0, 0]) == 0
    probe = np.array([[1, 6]] * 2, np.int32)
    pp = np.array([[15, 16], [11, 12]], np.int32)   # slots 15 and 0 (wrap)
    before = _live_snapshot(tcache)
    te = tm.probe_entropy(torch.from_numpy(probe).long(), torch.from_numpy(pp),
                          torch.from_numpy(pp), tcache)
    _assert_unchanged(before, tcache)
    je = jm.probe_entropy(params, jnp.asarray(probe), jnp.asarray(pp),
                          jnp.asarray(pp), jcache, entropy_impl="xla")
    close(te, je, 1e-4)


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_probe_and_rollout_leave_the_live_cache_unchanged(kind):
    """Mid-serve state of a real engine: a probe and a forced-answer
    rollout commit nothing — pos, cur and live K/V are bitwise unchanged —
    and a second probe gives the same EAT as the first."""
    cfg = tget("tiny")
    model = TModel(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"))
    ecfg = EngineConfig(max_reasoning_tokens=16, capacity=128, chunk_len=4,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind=kind, attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(delta=0.0), probe=make_probe(1, (6,)),
                           schedule="every_n", every_n=2, min_evals=1)
    eng = ReasoningEngine(model, ecfg, mon)
    toks, pos = _prompts(B=3, S=10, vocab=cfg.vocab)
    plen = (pos >= 0).sum(1)
    ss = eng._serve_setup(toks, plen, None, batch_size=3, max_tokens=16,
                          chunk_len=4)
    state = ss.state
    slots = [0, 1, 2]
    if ss.paged:
        state = eng.executor.ensure_chunk_pages(ss.alloc, state, slots, 4 + 2, cur=int(state.cache["cur"]))
    state = eng.executor.decode_chunk(state, 16, 4)
    if ss.paged:
        state = eng.executor.ensure_chunk_pages(ss.alloc, state, slots, 6, cur=int(state.cache["cur"]))
    before = _live_snapshot(state.cache)
    e1 = eng.executor.probe(state.cache, state.next_pos)
    _assert_unchanged(before, state.cache)
    toks1, _ = eng.force_answer(state, 4, greedy=True)
    _assert_unchanged(before, state.cache)
    assert torch.equal(eng.executor.probe(state.cache, state.next_pos), e1)
    toks2, _ = eng.force_answer(state, 4, greedy=True)
    assert torch.equal(toks1, toks2)


def test_entry_points_need_an_explicit_cpu_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: device='cuda' is valid here")
    cfg = tget("tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax({}, cfg)
