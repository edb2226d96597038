"""The port's mixture-of-experts family against the JAX reference on the CPU
(float32; the reference's single-device path, ``ShardCtx(mesh=None)``).

* ``router_topk``: top-k ids exactly, weights, probabilities and the aux
  loss within 1e-6.
* ``_capacity`` on the reference's cases and a grid around the dropless
  threshold (``T * k <= 4096``).
* The dispatch fed the reference's own routing ``(topw, topi)`` at a
  capacity-bound shape, ``(8, 512, 32)``, 8 experts, top 2, cf 1.25, the
  router pushed onto few experts so that many pairs are dropped: the
  trash-slot buffers (``buf_tok``, ``buf_w``, read out of the reference's
  own program by evaluating its jaxpr) are equal exactly, and the expert
  output is within 1e-5.
* ``moe_apply`` against a dense oracle (every expert on every token) with
  ample capacity; the combine is bitwise equal across two calls.
* The plain attention's scores at g = 1 and one query row (an MoE
  config's decode) equal the direct product's.
* ``tiny-moe`` and ``deepseek-moe-16b``.reduced(): prefill, decode and
  probe against the JAX ``Model`` within 1e-5; the paged self-EAT serve
  against the JAX engine (tokens, exits and answers exactly, EAT traces
  within 1e-5); paged == ring and same-weights proxy == self-EAT bitwise
  inside the port, overlapped == sync bitwise but for the last bits of the
  EAT traces of requests admitted behind a running chunk (rtol 1e-6, as
  in the reference); ``train_loss`` and every gradient
  leaf against ``jax.value_and_grad`` within 1e-5 (the router's gradient
  nonzero).
* A port checkpoint of ``tiny-moe`` is the reference's file byte for byte.
* The launcher serves ``--arch tiny-moe`` on the CPU.
"""
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import get_config as jget
from repro.core.eat import make_probe as jprobe
from repro.core.monitor import ReasoningMonitor as JMonitor
from repro.core.stopping import EATStopper as JStopper
from repro.data.synthetic import ChainTask, Tokens
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.serving.cache import CacheConfig as JCache
from repro.serving.cache import alloc_cache as jalloc
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReasoningEngine as JEngine
from repro.serving.sampler import SamplerConfig as JSampler
from repro.sharding.partition import ShardCtx
from repro.training.checkpoint import save_checkpoint as jsave
from repro.utils.treeutil import tree_flatten_with_paths as jflatten
from repro_torch.configs.base import ModelConfig, MoEConfig, get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.data.pipeline import device_put_batch
from repro_torch.models import moe
from repro_torch.models.common import mlp_apply
from repro_torch.models.model import Model, train_loss
from repro_torch.params import from_jax, to_jax
from repro_torch.serving.cache import CacheConfig, alloc_cache
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.proxy import ProxyConfig
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.train_loop import trainable
from repro_torch.utils.treeutil import tree_flatten_with_paths, tree_leaves

from _torch_threads import _one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
MOE_CONFIGS = ["tiny-moe", "deepseek-moe-16b-reduced"]


def _t(tree):
    """A JAX pytree of arrays -> the same nested dicts of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(n_routed=8, top_k=2, n_shared=1, cf=2.0, routed_scale=1.0):
    """The reference's ``tests/test_moe.py`` config, in both packages."""
    kw = dict(name="t", arch_type="moe", d_model=32, vocab=16, d_ff=64,
              dtype="float32")
    mo = dict(n_routed=n_routed, n_shared=n_shared, top_k=top_k, d_expert=16,
              capacity_factor=cf, routed_scale=routed_scale)
    return (JConfig(**kw, moe=JMoEConfig(**mo)),
            ModelConfig(**kw, moe=MoEConfig(**mo)))


def _layer(jcfg, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, _t(jp)


# ------------------------------------------------------------------ router


@pytest.mark.parametrize("top_k,n_routed,scale", [(1, 4, 1.0), (2, 8, 1.0),
                                                  (6, 16, 1.0), (2, 8, 2.5)])
def test_router_topk_matches_jax(top_k, n_routed, scale):
    jcfg, cfg = _cfgs(n_routed=n_routed, top_k=top_k, routed_scale=scale)
    jp, p = _layer(jcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (3, 7, 32))
    jw, ji, jaux = jmoe.router_topk(jp, x, jcfg)
    w, i, aux = moe.router_topk(p, torch.from_numpy(np.array(x)), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)
    assert w.dtype == aux.dtype == torch.float32
    jprobs = jax.nn.softmax(x @ jp["router"], axis=-1)
    probs = torch.softmax(torch.from_numpy(np.array(x)) @ p["router"], dim=-1)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("t,k,e,cf", [(8, 6, 160, 1.25), (65536, 6, 160, 1.25),
                                      (2048, 2, 8, 1.25), (2049, 2, 8, 1.25),
                                      (512, 6, 64, 1.25), (2048, 6, 64, 1.25),
                                      (4, 6, 64, 1.25), (4096, 1, 4, 2.0),
                                      (4097, 1, 4, 2.0)])
def test_capacity_rule_matches_jax(t, k, e, cf):
    assert moe._capacity(t, k, e, cf) == jmoe._capacity(t, k, e, cf)


def test_capacity_reference_cases():
    assert moe._capacity(8, 6, 160, 1.25) == 8                 # dropless decode
    assert moe._capacity(65536, 6, 160, 1.25) == int(np.ceil(65536 * 6 * 1.25 / 160))
    # deepseek-moe-16b at the smoke's traffic: a 4-row cohort prefill of
    # 512 tokens is capacity-bound, a 1-row admission prefill dropless
    assert moe._capacity(4 * 512, 6, 64, 1.25) == 240
    assert moe._capacity(512, 6, 64, 1.25) == 512


# ---------------------------------------------------------------- dispatch


def _reference_buffers(fn, *args):
    """Evaluate ``fn``'s jaxpr equation by equation and return (the value of
    every ``scatter`` it runs, in program order, and its outputs): the
    reference's ``buf_tok`` and ``buf_w`` before their trash slot is cut."""
    closed = jax.make_jaxpr(fn)(*args)
    jaxpr, env = closed.jaxpr, {}
    env.update(zip(jaxpr.constvars, closed.consts))
    env.update(zip(jaxpr.invars, args))

    def read(v):
        return v.val if isinstance(v, jcore.Literal) else env[v]

    scattered = []
    for eqn in jaxpr.eqns:
        subfuns, params = eqn.primitive.get_bind_params(eqn.params)
        out = eqn.primitive.bind(*subfuns, *map(read, eqn.invars), **params)
        outs = out if eqn.primitive.multiple_results else [out]
        env.update(zip(eqn.outvars, outs))
        if eqn.primitive.name == "scatter":
            scattered.append(np.asarray(outs[0]))
    return scattered, [read(v) for v in jaxpr.outvars]


@pytest.fixture(scope="module")
def bound_case():
    """A capacity-bound call: (8, 512, 32), 8 experts, top 2, cf 1.25 ->
    T k = 8192 > 4096, cap = 1280.  Every token leans towards the same
    experts (a shared offset in x), so those run over their capacity."""
    jcfg, cfg = _cfgs(n_routed=8, top_k=2, cf=1.25)
    jp, p = _layer(jcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 512, 32)) * 0.5 + 1.0
    jw, ji, _ = jmoe.router_topk(jp, x, jcfg)
    T = 8 * 512
    cap = jmoe._capacity(T, 2, 8, 1.25)
    args = (x.reshape(T, 32), jw.reshape(T, 2), ji.reshape(T, 2))
    ex = jp["experts"]

    def ref(xx, tw, ti):
        return jmoe._expert_compute(xx, tw, ti, ex["w_up"], ex["w_gate"],
                                    ex["w_down"], cfg=jcfg, e0=0, n_local=8,
                                    cap=cap, model_axis=None)

    scattered, (out,) = _reference_buffers(ref, *args)
    return dict(cfg=cfg, p=p, cap=cap, T=T, args=[np.array(a) for a in args],
                buffers=scattered, out=np.asarray(out))


def test_capacity_bound_dispatch_keeps_the_references_pairs(bound_case):
    c = bound_case
    _, tw, ti = c["args"]
    slot, buf_tok, buf_w = moe.dispatch(torch.from_numpy(tw),
                                        torch.from_numpy(ti).long(), 8, c["cap"])
    ref_tok, ref_w = (b[:-1] for b in c["buffers"])
    assert c["cap"] == 1280 and buf_tok.shape == (8 * c["cap"],)
    np.testing.assert_array_equal(buf_tok.numpy(), ref_tok)
    np.testing.assert_array_equal(buf_w.numpy(), ref_w)
    dropped = int((slot == 8 * c["cap"]).sum())
    empty = int((buf_tok == c["T"]).sum())
    assert dropped > 500 and empty > 500, (dropped, empty)
    # every kept pair sits where buf_tok says, with its own weight
    kept = slot < 8 * c["cap"]
    toks = torch.arange(c["T"])[:, None].expand_as(slot)
    assert torch.equal(buf_tok[slot[kept]], toks[kept])
    assert torch.equal(buf_w[slot[kept]], torch.from_numpy(tw)[kept])


def test_capacity_bound_expert_output_matches_jax(bound_case):
    c = bound_case
    x, tw, ti = (torch.from_numpy(a) for a in c["args"])
    y = moe.expert_compute(x, tw, ti.long(), c["p"]["experts"], c["cfg"], c["cap"])
    np.testing.assert_allclose(y.numpy(), c["out"], rtol=1e-5, atol=1e-5)


def test_combine_is_bitwise_across_calls(bound_case):
    c = bound_case
    x, tw, ti = (torch.from_numpy(a) for a in c["args"])
    ys = [moe.expert_compute(x, tw, ti.long(), c["p"]["experts"], c["cfg"],
                             c["cap"]) for _ in range(2)]
    assert torch.equal(ys[0], ys[1])


def _dense_oracle(p, x, cfg):
    """Every expert on every token, weighted by the router's choices."""
    topw, topi, _ = moe.router_topk(p, x, cfg)
    ex = p["experts"]
    ref = torch.zeros_like(x)
    for e in range(cfg.moe.n_routed):
        h = torch.nn.functional.silu(x @ ex["w_gate"][e]) * (x @ ex["w_up"][e])
        w_e = torch.where(topi == e, topw, 0.0).sum(-1)
        ref = ref + (h @ ex["w_down"][e]) * w_e[..., None]
    if cfg.moe.n_shared:
        ref = ref + mlp_apply(p["shared"], x, cfg)
    return ref


@pytest.mark.parametrize("top_k,n_routed", [(1, 4), (2, 8), (6, 16)])
def test_moe_apply_matches_dense_oracle_and_jax(top_k, n_routed):
    jcfg, cfg = _cfgs(n_routed=n_routed, top_k=top_k)
    jp, p = _layer(jcfg)
    jx = jax.random.normal(jax.random.PRNGKey(1), (2, 9, 32))
    x = torch.from_numpy(np.array(jx))
    y, aux = moe.moe_apply(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), _dense_oracle(p, x, cfg).numpy(),
                               rtol=1e-5, atol=1e-5)
    jy, jaux = jmoe.moe_apply(jp, jx, jcfg, ShardCtx(mesh=None))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(aux) > 0


@pytest.mark.parametrize("Sq,g", [(1, 1), (2, 1), (1, 4)])
def test_plain_scores_of_one_query_row(Sq, g):
    """MoE configs are multi-head (g = 1): at decode (Sq = 1) the plain
    attention's score product gets a copied second row, so that cuBLAS
    sums d as its GEMM kernels and the CUDA kernels do, not as its GEMV;
    the scores are the direct product's, in its shape."""
    from repro_torch.kernels.flash_attention.ops import _scores

    gen = torch.Generator().manual_seed(0)
    qf = torch.randn(2, Sq, 3, g, 32, generator=gen)
    kb = torch.randn(2, 16, 3, 32, generator=gen)
    s = _scores(qf, kb)
    ref = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb)
    assert s.shape == ref.shape == (2, 3, g, Sq, 16)
    np.testing.assert_allclose(s.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    if Sq * g > 1:
        assert torch.equal(s, ref)


# --------------------------------------------------------------- the model


def _configs(name):
    if name == "deepseek-moe-16b-reduced":
        return jget("deepseek-moe-16b").reduced(), get_config("deepseek-moe-16b").reduced()
    return jget(name), get_config(name)


def test_reduced_matches_reference():
    mine, ref = _configs("deepseek-moe-16b-reduced")[::-1]
    assert mine.moe is not None and ref.moe.__dict__ == mine.moe.__dict__
    assert (mine.n_layers, mine.d_model, mine.n_heads, mine.n_kv_heads,
            mine.head_dim, mine.d_ff, mine.vocab, mine.dtype) == \
           (ref.n_layers, ref.d_model, ref.n_heads, ref.n_kv_heads,
            ref.head_dim, ref.d_ff, ref.vocab, ref.dtype)
    assert mine.moe_layer_mask() == ref.moe_layer_mask() == (False, True)


@pytest.fixture(scope="module", params=MOE_CONFIGS)
def pair(request):
    jcfg, cfg = _configs(request.param)
    jmodel = JModel(jcfg, attn_impl="xla")
    jparams = jmodel.init(jax.random.PRNGKey(11))
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, cfg, params


def test_param_layout_round_trips(pair):
    _, jparams, cfg, params = pair
    assert len(params["layers"]) == cfg.n_layers
    assert "ffn" in params["layers"][0] and "moe" in params["layers"][1]
    back = dict(tree_flatten_with_paths(to_jax(params, cfg)))
    ref = dict(jflatten(jparams))
    assert sorted(back) == sorted(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(back[path].numpy(), np.asarray(leaf), path)


def test_prefill_decode_probe_match_jax(pair):
    jm, params, cfg, tparams = pair
    tm = Model(cfg, tparams)
    B, S = 2, 12
    rng = np.random.default_rng(0)
    toks = rng.integers(4, cfg.vocab, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, :4], pos[1, 4:], toks[1, :4] = -1, np.arange(S - 4), 0
    jcache, tcache = jalloc(jm.cfg, B, 32), alloc_cache(cfg, B, 32, device="cpu")
    jh, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(pos),
                            jnp.asarray(pos), jcache)
    th = tm.prefill(torch.from_numpy(toks).long(), torch.from_numpy(pos),
                    torch.from_numpy(pos), tcache)
    np.testing.assert_allclose(_np(th), _np(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tm.logits(th[:, -1:])),
                               _np(jm.logits(params, jh[:, -1:])), rtol=1e-5, atol=1e-5)
    nxt, p1 = np.array([[7], [9]], np.int32), np.array([[12], [8]], np.int32)
    jl, jcache = jm.decode_step(params, jnp.asarray(nxt), jnp.asarray(p1),
                                jnp.asarray(p1), jcache)
    tl = tm.decode_step(torch.from_numpy(nxt).long(), torch.from_numpy(p1),
                        torch.from_numpy(p1), tcache)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=1e-5)
    probe = np.array([[1, 6]] * 2, np.int32)
    pp = p1 + 1 + np.arange(2, dtype=np.int32)[None]
    je = jm.probe_entropy(params, jnp.asarray(probe), jnp.asarray(pp),
                          jnp.asarray(pp), jcache, entropy_impl="xla")
    te = tm.probe_entropy(torch.from_numpy(probe).long(), torch.from_numpy(pp),
                          torch.from_numpy(pp), tcache)
    np.testing.assert_allclose(_np(te), _np(je), rtol=1e-5, atol=1e-5)


def _ecfg(cls, sampler, cache, capacity=256):
    return cls(max_reasoning_tokens=24, capacity=capacity, pad_id=Tokens.PAD,
               end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
               eos_id=Tokens.EOS, chunk_len=8, sampler=sampler(greedy=True),
               cache=cache)


def _mon(cls_mon, cls_stop, probe, delta):
    return cls_mon(stopper=cls_stop(alpha=0.2, delta=delta),
                   probe=probe(Tokens.END_THINK, (Tokens.ANS,)),
                   schedule="every_n", every_n=4, min_evals=1)


def _jax_serve(jmodel, jparams, batch, delta):
    eng = JEngine(jmodel, jparams,
                  _ecfg(JEngineConfig, JSampler,
                        JCache(kind="paged", page_size=16, attn_impl="xla")),
                  _mon(JMonitor, JStopper, jprobe, delta))
    return eng.serve(batch["prompts"], batch["prompt_len"], jax.random.PRNGKey(0),
                     batch_size=4, max_tokens=24, answer_len=4, record_trace=True)


def _serve(model, batch, delta, *, kind="paged", proxy=None, overlap=False):
    eng = ReasoningEngine(
        model, _ecfg(EngineConfig, SamplerConfig,
                     CacheConfig(kind=kind, page_size=16, attn_impl="auto"),
                     capacity=256 + (8 if overlap else 0)),
        _mon(ReasoningMonitor, EATStopper, make_probe, delta), proxy=proxy)
    return eng.serve(batch["prompts"], batch["prompt_len"], None, batch_size=4,
                     max_tokens=24, answer_len=4, record_trace=True,
                     overlap=overlap)


def _assert_bit_equal(ref, out, slots=True):
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        assert (r["n_reasoning"], r["exit_reason"], r["ended_think"]) == \
               (o["n_reasoning"], o["exit_reason"], o["ended_think"])
        if slots:
            assert r["slot"] == o["slot"]
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
        np.testing.assert_array_equal(r["answer_tokens"], o["answer_tokens"])
        assert r["eat_trace"] == o["eat_trace"]


@pytest.fixture(scope="module")
def batch():
    return ChainTask().serve_batch(np.random.default_rng(7), 6)


@pytest.mark.parametrize("delta", [1e9, 0.0])
def test_paged_serve_matches_jax(pair, batch, delta):
    jmodel, jparams, cfg, params = pair
    ref = _jax_serve(jmodel, jparams, batch, delta)
    out = _serve(Model(cfg, params), batch, delta)
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
                                   rtol=1e-5, atol=1e-5)
    if delta == 1e9:
        assert {o["exit_reason"] for o in out} == {"eat"}


@pytest.fixture(scope="module")
def paged_serve(pair, batch):
    _, _, cfg, params = pair
    model = Model(cfg, params)
    return model, _serve(model, batch, 0.0)


def test_paged_equals_ring_bitwise(paged_serve, batch):
    model, paged = paged_serve
    _assert_bit_equal(paged, _serve(model, batch, 0.0, kind="ring"), slots=False)


def test_same_weights_proxy_equals_self_eat_bitwise(paged_serve, batch):
    model, paged = paged_serve
    _assert_bit_equal(paged, _serve(model, batch, 0.0, proxy=ProxyConfig(model=model)))


def test_overlap_equals_sync(paged_serve, batch):
    """Tokens, exits, slots, answers and the traces' evaluation steps
    exactly; the first cohort's EAT traces bitwise.  A request admitted
    behind a chunk that still runs decodes at other offsets inside its
    attention blocks, and its variances may differ in the last bits
    (rtol 1e-6), as the JAX package's overlapped serve of these weights
    does (ROADMAP §3, PR 24)."""
    model, paged = paged_serve
    out = _serve(model, batch, 0.0, overlap=True)
    for r, o in zip(paged, out):
        assert (r["n_reasoning"], r["exit_reason"], r["ended_think"], r["slot"]) \
            == (o["n_reasoning"], o["exit_reason"], o["ended_think"], o["slot"])
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
        np.testing.assert_array_equal(r["answer_tokens"], o["answer_tokens"])
        assert [e[:2] for e in r["eat_trace"]] == [e[:2] for e in o["eat_trace"]]
        if r["request"] < 4:
            assert r["eat_trace"] == o["eat_trace"], r["request"]
        np.testing.assert_allclose([e[2] for e in o["eat_trace"]],
                                   [e[2] for e in r["eat_trace"]], rtol=1e-6, atol=0)


# ---------------------------------------------------------------- training


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(x, it) for x in tree]
    return next(it)


def test_train_loss_and_grads_match_jax(pair):
    jmodel, jparams, cfg, params = pair
    batch = ChainTask(seq_len=40).batch(np.random.default_rng(0), 4)
    jf = lambda p: jmodel.train_loss(  # noqa: E731
        p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)
    (_, jm), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jparams)
    tp = trainable(params)
    loss, m = train_loss(tp, cfg, device_put_batch(batch, "cpu"), remat=True)
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    g = dict(tree_flatten_with_paths(to_jax(_rebuild(tp, iter(grads)), cfg)))
    for k in ("loss", "ce", "z_loss", "accuracy", "tokens", "aux_loss"):
        np.testing.assert_allclose(_np(m[k]), _np(jm[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    jg = dict(jflatten(jg))
    assert sorted(jg) == sorted(g)
    for path, ref in jg.items():
        np.testing.assert_allclose(_np(g[path]), _np(ref), rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    router = g["stack/moe_layers/moe/router"]
    assert float(router.abs().max()) > 0
    aux = float(m["aux_loss"].detach())
    assert math.isfinite(aux) and aux > 0


def test_checkpoint_is_the_references_bytes(tmp_path):
    jcfg, cfg = _configs("tiny-moe")
    jparams = JModel(jcfg, attn_impl="xla").init(jax.random.PRNGKey(3))
    jsave(str(tmp_path / "ref.ckpt"), jparams)
    save_checkpoint(str(tmp_path / "port.ckpt"),
                    from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu"),
                    cfg)
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "ref.ckpt").read_bytes()


def test_serve_cli_tiny_moe_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "tiny-moe", "--cache", "paged", "--attn-impl", "auto",
         "--requests", "6", "--batch", "2", "--budget", "16"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 6 requests through 2 slots on cpu" in out.stdout
