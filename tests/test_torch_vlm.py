"""The port's VLM (``qwen2-vl-7b``: the dense decoder with qkv bias and
M-RoPE, stub image patches in front of a prompt) against the JAX reference
on the CPU (float32; the config's ``reduced()`` on both sides: 2 layers, d
128, 4/4 heads of 32, sections (4, 6, 6), 8 patches, vocab 512; and a g 7
variant of it, 7 q heads on 1 kv head of 32; parameters carried by
``params.from_jax``; the JAX side on ``attn_impl="xla"``).

* ``apply_mrope`` on distinct seeded (t, h, w) streams against the
  reference's, at sections (16, 24, 24) over head dim 128 and (4, 6, 6)
  over 32, within 1e-5; with t = h = w it is the port's ``apply_rope`` bit
  for bit, and sections in another order give another result (a wrong
  split shows only on distinct streams).
* The config equals the reference's field by field, with the published
  hyperparameters spot checked; ``param_specs`` gives the reference's leaf
  paths, shapes and dtypes at full width (depth cut to 2);
  ``to_jax(from_jax(p))`` is ``p`` leaf for leaf on both variants.
* ``prefill`` with image embeds in front of a left-padded prompt, the
  patches at distinct (t, h, w) positions (and its logits), then
  ``decode_step`` and ``probe_entropy``, on a ring and a paged cache,
  against the JAX ``Model`` within 1e-5, on both variants.
* A paged text-only ``serve()`` against the JAX engine: requests, tokens,
  exits and answers exactly, EAT traces within 1e-5.
* ``start(image_embeds=)`` -> ``reason()`` -> ``force_answer(4)`` against
  the JAX engine: tokens, exits and answers exactly, every chunk's EAT
  within 1e-5; a second ``start()`` on the engine with other patches gives
  what a new engine gives; a capacity below P + S and patches for a model
  that is not a VLM are refused.
* A reduced VLM as the proxy tier of a reduced VLM generator with other
  weights, against the JAX engine.
* ``train_loss`` with image embeds and (B, P + S, 3) positions (distinct
  streams on the patches), and every gradient leaf, against
  ``jax.value_and_grad`` within 1e-5, the batch through ``device_put_batch``.
* ``launch.serve`` accepts ``--arch qwen2-vl-7b`` (text only).
"""
import dataclasses

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
from repro.models.common import apply_mrope as japply_mrope
from repro.serving.cache import CacheConfig as JCache
from repro.serving.cache import alloc_cache as jalloc
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReasoningEngine as JEngine
from repro.serving.proxy import ProxyConfig as JProxyConfig
from repro.serving.sampler import SamplerConfig as JSampler
from repro.utils.treeutil import tree_flatten_with_paths as jflatten
from repro_torch.configs.base import get_config
from repro_torch.core.eat import eval_eat, make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.data.pipeline import device_put_batch
from repro_torch.launch import serve as serve_cli
from repro_torch.models.common import apply_mrope, apply_rope, positions_for
from repro_torch.models.model import Model, train_loss
from repro_torch.params import from_jax, param_specs, to_jax
from repro_torch.serving.cache import CacheConfig, alloc_cache, alloc_paged_cache
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.proxy import ProxyConfig
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training.train_loop import trainable
from repro_torch.utils.treeutil import tree_flatten_with_paths, tree_leaves

from _torch_threads import _one_thread  # noqa: F401
from test_torch_moe import _rebuild

NAME = "qwen2-vl-7b"
FIELDS = ("name", "arch_type", "source", "n_layers", "d_model", "n_heads",
          "n_kv_heads", "head_dim", "d_ff", "vocab", "activation", "qk_norm",
          "attn_bias", "tie_embeddings", "embed_scale", "rmsnorm_one_plus",
          "norm_eps", "rope_theta", "mrope_sections", "n_image_patches",
          "logit_softcap", "sliding_window", "attn_temperature", "dtype")
# arXiv:2409.12191 (Qwen2-VL-7B's language backbone)
PUBLISHED = dict(arch_type="vlm", n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
                 resolved_head_dim=128, d_ff=18944, vocab=152_064,
                 padded_vocab=152_064, activation="silu", tie_embeddings=False,
                 attn_bias=True, mrope_sections=(16, 24, 24), n_image_patches=256,
                 rope_theta=1_000_000.0)
VARIANTS = ["reduced", "g7"]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _configs(variant):
    """The reduced config on both sides, or its g 7 variant (7 q heads on
    one kv head of 32)."""
    jcfg, cfg = jget(NAME).reduced(), get_config(NAME).reduced()
    if variant == "g7":
        jcfg, cfg = (dataclasses.replace(c, n_heads=7, n_kv_heads=1) for c in (jcfg, cfg))
    return jcfg, cfg


def _streams(shape, seed):
    """Distinct seeded (t, h, w) position ids (..., 3)."""
    return np.random.default_rng(seed).integers(-3, 600, size=shape + (3,)).astype(np.int32)


# ------------------------------------------------------------------ M-RoPE


@pytest.mark.parametrize("sections,D", [((16, 24, 24), 128), ((4, 6, 6), 32)])
def test_apply_mrope_matches_jax_on_distinct_streams(sections, D):
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 9, 3, D)).astype(np.float32)
    pos3 = _streams((2, 9), D)
    assert len({tuple(p) for p in pos3.reshape(-1, 3).T.tolist()}) == 3
    ref = japply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    out = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6, sections)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # another order of the same sections moves the result
    other = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                        tuple(reversed(sections)))
    assert float((other - out).abs().max()) > 1e-2
    # t = h = w: plain RoPE, bit for bit
    p1 = torch.from_numpy(pos3[..., 0].copy())
    tx = torch.from_numpy(x)
    assert torch.equal(apply_mrope(tx, positions_for(get_config(NAME), p1), 1e6,
                                   sections), apply_rope(tx, p1, 1e6))


def test_apply_mrope_refuses_sections_of_another_width():
    with pytest.raises(ValueError, match="sum"):
        apply_mrope(torch.zeros(1, 2, 1, 32), torch.zeros(1, 2, 3, dtype=torch.int32),
                    1e4, (4, 6, 4))


# ------------------------------------------------------------------ params


def test_config_matches_reference_and_publication():
    for ref, mine in ((jget(NAME), get_config(NAME)),
                      (jget(NAME).reduced(), get_config(NAME).reduced())):
        for f in FIELDS:
            assert getattr(mine, f) == getattr(ref, f), f
        assert mine.moe is mine.ssm is mine.mla is None
        assert (mine.resolved_head_dim, mine.padded_vocab) == \
            (ref.resolved_head_dim, ref.padded_vocab)
    for f, want in PUBLISHED.items():
        assert getattr(get_config(NAME), f) == want, f
    red = get_config(NAME).reduced()
    assert (red.n_layers, red.d_model, red.head_dim, red.vocab, red.mrope_sections,
            red.n_image_patches, red.dtype) == (2, 128, 32, 512, (4, 6, 6), 8, "float32")


def test_param_specs_are_the_references_at_full_width():
    """Paths, shapes and dtypes of every leaf at full width with the depth
    cut to 2 (abstract on both sides): the dense tree with qkv bias, an
    untied head; 7.62 B parameters at the full 28 layers."""
    jcfg, cfg = (dataclasses.replace(c, n_layers=2) for c in (jget(NAME), get_config(NAME)))
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    ref = {path: (tuple(s.shape), s.dtype.name) for path, s in jflatten(shapes)}
    assert param_specs(cfg) == ref
    assert ref["stack/layers/attn/bk"] == ((2, 512), "bfloat16")
    assert ref["embed/lm_head"] == ((3584, 152_064), "bfloat16")
    full = param_specs(get_config(NAME))
    n = sum(int(np.prod(s)) for s, _ in full.values())
    assert 7.6e9 < n < 7.65e9


def _pair(variant, seed=11):
    jcfg, cfg = _configs(variant)
    jmodel = JModel(jcfg, attn_impl="xla")
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, cfg, params


@pytest.fixture(scope="module")
def reduced():
    return _pair("reduced")


@pytest.fixture(scope="module")
def g7():
    return _pair("g7")


@pytest.fixture(params=VARIANTS)
def pair(request, reduced, g7):
    return {"reduced": reduced, "g7": g7}[request.param]


def test_param_layout_round_trips(pair):
    _, jparams, cfg, params = pair
    ref = dict(jflatten(jax.tree_util.tree_map(np.asarray, jparams)))
    back = dict(tree_flatten_with_paths(to_jax(params, cfg)))
    assert sorted(back) == sorted(ref)
    for path, leaf in ref.items():
        assert torch.equal(back[path], torch.from_numpy(np.array(leaf))), path


# ------------------------------------------------------------------ model


def _port_cache(cfg, kind, B, C):
    if kind == "ring":
        return alloc_cache(cfg, B, C, device="cpu")
    cache = alloc_paged_cache(cfg, B, C, 4, 1 + B * C // 4, device="cpu")
    # every row's blocks mapped to pages of its own, in a shuffled order
    pages = np.random.default_rng(1).permutation(B * C // 4) + 1
    cache["page_table"].copy_(torch.from_numpy(pages.reshape(B, C // 4).astype(np.int32)))
    return cache


def _image(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_image_patches, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_prefill_with_image_decode_probe_match_jax(pair, kind):
    """[8 patches | pads | 12-token prompt], row 1 with 4 pads: the patches
    at distinct (t, h, w) positions, the text at t = h = w (shifted by P),
    then one decode step and a 2-token probe, port against reference within
    1e-5."""
    jm, jparams, cfg, params = pair
    tm = Model(cfg, params)
    B, S, pad, P = 2, 12, 4, cfg.n_image_patches
    rng = np.random.default_rng(3)
    toks = rng.integers(4, cfg.vocab, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, :pad], pos[1, pad:], toks[1, :pad] = -1, np.arange(S - pad), 0
    pos1d = np.concatenate([np.tile(np.arange(P, dtype=np.int32), (B, 1)),
                            np.where(pos >= 0, pos + P, -1)], 1)
    pos3 = np.repeat(pos1d[..., None], 3, axis=-1)
    pos3[:, :P, 1] = np.arange(P) // 4               # rows of a 2 x 4 patch grid
    pos3[:, :P, 2] = np.arange(P) % 4
    img = _image(cfg, B, 9)
    jcache, tcache = jalloc(jm.cfg, B, 32), _port_cache(cfg, kind, B, 32)
    jh, jcache = jm.prefill(jparams, jnp.asarray(toks), jnp.asarray(pos3),
                            jnp.asarray(pos1d), jcache, image_embeds=jnp.asarray(img))
    th = tm.prefill(torch.from_numpy(toks).long(), torch.from_numpy(pos3),
                    torch.from_numpy(pos1d), tcache, image_embeds=torch.from_numpy(img))
    assert th.shape == (B, P + S, cfg.d_model)
    np.testing.assert_allclose(_np(th), _np(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tm.logits(th[:, -1:])),
                               _np(jm.logits(jparams, jh[:, -1:])), rtol=1e-5, atol=1e-5)
    nxt = np.array([[7], [9]], np.int32)
    p1 = np.array([[P + S], [P + S - pad]], np.int32)
    p13 = np.repeat(p1[..., None], 3, axis=-1)
    jl, jcache = jm.decode_step(jparams, jnp.asarray(nxt), jnp.asarray(p13),
                                jnp.asarray(p1), jcache)
    tl = tm.decode_step(torch.from_numpy(nxt).long(), positions_for(cfg, torch.from_numpy(p1)),
                        torch.from_numpy(p1), tcache)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=1e-5)
    next_pos = p1[:, 0] + 1
    pp = next_pos[:, None] + np.arange(2, dtype=np.int32)[None]
    je = jm.probe_entropy(jparams, jnp.asarray(np.array([[1, 6]] * 2, np.int32)),
                          jnp.asarray(np.repeat(pp[..., None], 3, axis=-1)),
                          jnp.asarray(pp), jcache, entropy_impl="xla")
    te = eval_eat(tm, tcache, make_probe(1, (6,)), torch.from_numpy(next_pos))
    np.testing.assert_allclose(_np(te), _np(je), rtol=1e-5, atol=1e-5)
    assert bool(torch.isfinite(te).all())


def test_eval_eat_passes_mrope_positions(pair, monkeypatch):
    """``eval_eat`` hands the probe forward (B, m, 3) positions, t = h = w =
    next_pos + [0..m)."""
    _, _, cfg, params = pair
    tm = Model(cfg, params)
    seen = {}

    def probe_entropy(toks, positions, pos1d, cache, **kw):
        seen["positions"], seen["pos1d"] = positions, pos1d
        return torch.zeros(toks.shape[0])

    monkeypatch.setattr(tm, "probe_entropy", probe_entropy)
    eval_eat(tm, None, make_probe(1, (6,)), torch.tensor([5, 9], dtype=torch.int32))
    assert seen["positions"].shape == (2, 2, 3)
    for i in range(3):
        assert torch.equal(seen["positions"][..., i], seen["pos1d"])
    assert seen["pos1d"].tolist() == [[5, 6], [9, 10]]


# ----------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def batch():
    return ChainTask().serve_batch(np.random.default_rng(7), 6)


def _ecfg(cls, sampler, cache, capacity=256, chunk=8):
    return cls(max_reasoning_tokens=24, capacity=capacity, pad_id=Tokens.PAD,
               end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
               eos_id=Tokens.EOS, chunk_len=chunk, sampler=sampler(greedy=True),
               cache=cache)


def _mon(cls_mon, cls_stop, probe, delta=1e9, min_evals=1):
    return cls_mon(stopper=cls_stop(alpha=0.2, delta=delta),
                   probe=probe(Tokens.END_THINK, (Tokens.ANS,)),
                   schedule="every_n", every_n=4, min_evals=min_evals)


def _check_serve(out, ref):
    """Requests in the reference's order, their tokens, exits and answers
    exactly (the reference's results name no slot); EAT traces within
    1e-5."""
    assert len(out) == len(ref)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o["reasoning_tokens"],
                                      np.asarray(r["reasoning_tokens"]))
        assert (o["request"], o["n_reasoning"], o["exit_reason"], o["ended_think"]) == \
               (r["request"], r["n_reasoning"], r["exit_reason"], r["ended_think"])
        np.testing.assert_array_equal(o["answer_tokens"], np.asarray(r["answer_tokens"]))
        assert [e[:2] for e in o["eat_trace"]] == [e[:2] for e in r["eat_trace"]]
        np.testing.assert_allclose([e[2] for e in o["eat_trace"]],
                                   [e[2] for e in r["eat_trace"]], rtol=1e-5, atol=1e-5)


def test_paged_text_serve_matches_jax(reduced, batch):
    """At delta 1e9 every request exits by EAT at its first evaluation."""
    jmodel, jparams, cfg, params = reduced
    jeng = JEngine(jmodel, jparams, _ecfg(JEngineConfig, JSampler,
                                         JCache(kind="paged", page_size=16,
                                                attn_impl="xla")),
                   _mon(JMonitor, JStopper, jprobe))
    ref = jeng.serve(batch["prompts"], batch["prompt_len"], jax.random.PRNGKey(0),
                     batch_size=4, max_tokens=24, answer_len=4, record_trace=True)
    eng = ReasoningEngine(Model(cfg, params), _ecfg(
        EngineConfig, SamplerConfig, CacheConfig(kind="paged", page_size=16,
                                                 attn_impl="auto")),
        _mon(ReasoningMonitor, EATStopper, make_probe))
    out = eng.serve(batch["prompts"], batch["prompt_len"], None, batch_size=4,
                    max_tokens=24, answer_len=4, record_trace=True)
    _check_serve(out, ref)
    assert len(out) == 6 and {o["exit_reason"] for o in out} == {"eat"}


def _traced(executor, trace):
    """Record every chunk boundary's (n_reasoning, n_evals, EAT, EMA var)."""
    chunk = executor.decode_chunk

    def run(*a, **kw):
        st = chunk(*a, **kw)
        s = st.monitor.stop_state
        trace.append([_np(x).tolist() for x in (st.n_reasoning, st.monitor.n_evals,
                                                s.last, s.ema.var)])
        return st
    executor.decode_chunk = run


def _exits(st):
    """Per row: reasoning tokens, exit reason (eat / end_think / budget)."""
    stop, ended = np.asarray(st.monitor.stop_flag), np.asarray(st.ended_think)
    n = np.asarray(st.n_reasoning)
    toks = np.asarray(st.out_tokens)
    return [(toks[b, :n[b]].tolist(),
             "eat" if stop[b] else "end_think" if ended[b] else "budget")
            for b in range(len(n))]


def _port_engine(model, capacity=96):
    return ReasoningEngine(model, _ecfg(EngineConfig, SamplerConfig,
                                        CacheConfig(kind="ring", attn_impl="auto"),
                                        capacity=capacity, chunk=4),
                           _mon(ReasoningMonitor, EATStopper, make_probe, min_evals=2))


def test_start_image_embeds_reason_force_answer_match_jax_engine(reduced, batch):
    """The reference's image entry point on the same weights, patches and
    prompts (a ring cache, the page-native block read, a probe every 4
    tokens, exit at the 2nd evaluation): every row exits by EAT with the
    reference's tokens and answers, next_pos = prompt_len + P; a second
    start() with other patches on the engine gives a new engine's results
    (the patches' K/V land in the kept cache)."""
    jmodel, jparams, cfg, params = reduced
    prompts, lens = batch["prompts"][:4], batch["prompt_len"][:4]
    img = _image(cfg, 4, 5)
    jeng = JEngine(jmodel, jparams, _ecfg(JEngineConfig, JSampler,
                                         JCache(kind="ring", attn_impl="xla"),
                                         capacity=96, chunk=4),
                   _mon(JMonitor, JStopper, jprobe, min_evals=2))
    jtrace = []
    _traced(jeng.executor, jtrace)
    jst = jeng.start(jnp.asarray(prompts), jnp.asarray(lens), jax.random.PRNGKey(0),
                     image_embeds=jnp.asarray(img))
    jst = jeng.reason(jst)
    jans, _ = jeng.force_answer(jst, 4, greedy=True)

    model = Model(cfg, params)
    eng = _port_engine(model)
    trace = []
    _traced(eng.executor, trace)
    st0 = eng.start(prompts, lens, None, image_embeds=img)
    assert st0.next_pos.tolist() == (lens + cfg.n_image_patches).tolist()
    st = eng.reason(st0)
    ans, _ = eng.force_answer(st, 4, greedy=True)
    assert _exits(st) == _exits(jst)
    assert {why for _, why in _exits(st)} == {"eat"}
    np.testing.assert_array_equal(ans.numpy(), np.asarray(jans))
    assert len(trace) == len(jtrace) >= 2
    for t, j in zip(trace, jtrace):
        assert t[:2] == j[:2]
        np.testing.assert_allclose(t[2:], j[2:], rtol=1e-5, atol=1e-5)

    img2 = _image(cfg, 4, 6)
    st2 = eng.reason(eng.start(prompts, lens, None, image_embeds=img2))
    ans2, _ = eng.force_answer(st2, 4, greedy=True)
    new = _port_engine(model)
    st3 = new.reason(new.start(prompts, lens, None, image_embeds=img2))
    ans3, _ = new.force_answer(st3, 4, greedy=True)
    assert _exits(st2) == _exits(st3) and torch.equal(ans2, ans3)
    assert torch.equal(st2.monitor.stop_state.ema.var, st3.monitor.stop_state.ema.var)


def test_start_refusals(pair, batch):
    _, _, cfg, params = pair
    prompts, lens = batch["prompts"][:4], batch["prompt_len"][:4]
    S, P = prompts.shape[1], cfg.n_image_patches
    with pytest.raises(ValueError, match="cannot hold"):
        _port_engine(Model(cfg, params), capacity=P + S - 1).start(
            prompts, lens, None, image_embeds=_image(cfg, 4, 1))
    dense = dataclasses.replace(cfg, arch_type="dense", mrope_sections=(),
                                n_image_patches=0)
    with pytest.raises(ValueError, match="not a VLM"):
        _port_engine(Model(dense, params)).start(prompts, lens, None,
                                                 image_embeds=_image(cfg, 4, 1))


def test_vlm_proxy_serve_matches_jax(reduced, batch):
    """The reduced VLM generator monitored by a reduced VLM of other
    weights (ring cache, delta 0.2): tokens, exits and answers exactly, the
    proxy's EAT traces within 1e-5."""
    jgen, jgp, cfg, gp = reduced
    jprox, jpp, _, pp = _pair("reduced", seed=5)
    ecfg = dict(capacity=320)
    jeng = JEngine(jgen, jgp, _ecfg(JEngineConfig, JSampler,
                                   JCache(kind="ring", page_size=16, attn_impl="xla"),
                                   **ecfg),
                   _mon(JMonitor, JStopper, jprobe, delta=0.2),
                   proxy=JProxyConfig(model=jprox, params=jpp))
    ref = jeng.serve(batch["prompts"], batch["prompt_len"], jax.random.PRNGKey(0),
                     batch_size=4, max_tokens=24, answer_len=4, record_trace=True)
    eng = ReasoningEngine(Model(cfg, gp), _ecfg(
        EngineConfig, SamplerConfig, CacheConfig(kind="ring", page_size=16,
                                                 attn_impl="auto"), **ecfg),
        _mon(ReasoningMonitor, EATStopper, make_probe, delta=0.2),
        proxy=ProxyConfig(model=Model(cfg, pp)))
    out = eng.serve(batch["prompts"], batch["prompt_len"], None, batch_size=4,
                    max_tokens=24, answer_len=4, record_trace=True)
    assert eng.monitor_mode == "proxy"
    _check_serve(out, ref)


# ---------------------------------------------------------------- training


def _vlm_batch(cfg, seed=0):
    """ChainTask rows of 40 tokens behind 8 patches: targets and loss mask 0
    on the patches, the patches at distinct (t, h, w), the text at t = h =
    w shifted by P."""
    b = ChainTask(seq_len=40).batch(np.random.default_rng(seed), 4)
    B, S = b["tokens"].shape
    P = cfg.n_image_patches
    pos1d = np.concatenate([np.tile(np.arange(P, dtype=np.int32), (B, 1)),
                            b["pos1d"] + P], 1)
    pos3 = np.repeat(pos1d[..., None], 3, axis=-1)
    pos3[:, :P, 1], pos3[:, :P, 2] = np.arange(P) // 4, np.arange(P) % 4
    return {"tokens": b["tokens"],
            "targets": np.concatenate([np.zeros((B, P), np.int32), b["targets"]], 1),
            "loss_mask": np.concatenate([np.zeros((B, P), np.float32),
                                         b["loss_mask"]], 1),
            "positions": pos3, "pos1d": pos1d, "image_embeds": _image(cfg, B, 2)}


def test_train_loss_and_grads_with_image_embeds_match_jax(reduced):
    jmodel, jparams, cfg, params = reduced
    batch = _vlm_batch(cfg)
    jf = lambda p: jmodel.train_loss(  # noqa: E731
        p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)
    (_, jm), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jparams)
    tp = trainable(params)
    on_dev = device_put_batch(batch, "cpu")
    assert on_dev["image_embeds"].shape == (4, cfg.n_image_patches, cfg.d_model)
    loss, m = train_loss(tp, cfg, on_dev, remat=True)
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    g = dict(tree_flatten_with_paths(to_jax(_rebuild(tp, iter(grads)), cfg)))
    for k in ("loss", "ce", "z_loss", "accuracy", "tokens"):
        np.testing.assert_allclose(_np(m[k]), _np(jm[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    jg = dict(jflatten(jg))
    assert sorted(jg) == sorted(g)
    for path, ref in jg.items():
        np.testing.assert_allclose(_np(g[path]), _np(ref), rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    assert float(g["stack/layers/attn/bq"].abs().max()) > 0


def test_serve_cli_accepts_the_arch(monkeypatch):
    """``--arch qwen2-vl-7b`` resolves and passes the launcher's checks (text
    only); the run is stopped where it would pick the device and allocate
    the full-width model."""
    seen = {}

    def stop(device):
        seen["device"] = device
        raise SystemExit(0)

    monkeypatch.setattr(serve_cli, "resolve_device", stop)
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", NAME, "--cache", "paged", "--requests", "8"])
    assert seen == {"device": "cuda"}
