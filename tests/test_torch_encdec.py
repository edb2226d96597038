"""The port's encoder-decoder (``seamless-m4t-large-v2``: a bidirectional
encoder over stub frontend frames, a decoder that cross-attends to it)
against the JAX reference on the CPU (float32; the config's ``reduced()``
on both sides: 2 + 2 layers, d 128, 4 heads of 32, 32 frames, vocab 512;
parameters carried by ``params.from_jax``; the JAX side on
``attn_impl="xla"``, as its own tests run it).

* The config equals the reference's field by field, with the published
  hyperparameters spot checked; ``param_specs`` gives the reference's leaf
  paths, shapes and dtypes at full width (depth cut to 2 + 2, on the meta
  device): the decoder under ``stack/dec_layers`` with ``norm_c`` and
  ``cross``, the encoder under ``stack/enc_layers`` and ``stack/enc_norm``.
* ``to_jax(from_jax(p))`` is ``p`` leaf for leaf, and a port checkpoint is
  the reference's file byte for byte.
* ``encode`` against the reference's, a full-sequence decoder block with
  its cross K/V made in the call (``attn_block_full(enc_kv=...)``), and
  ``cross_attention`` at m 1 and m S, within 1e-5.
* ``prefill`` with frames (and its logits), ``decode_step`` and
  ``probe_entropy`` against the JAX ``Model`` within 1e-5, on a ring and a
  paged cache, with prompts of 12 and 20 tokens; the probe leaves the
  cross K/V, ``enc_pos``, ``pos`` and ``cur`` as they were.
* ``start(frames=)`` -> ``reason()`` -> ``force_answer(4)`` against the JAX
  engine on the same parameters, frames and prompts: greedy tokens, exits
  and exit reasons exactly, the EAT trace of every chunk within 1e-5; a
  second ``start()`` on the same engine with other frames gives what a
  new engine gives (the cross K/V are written into the kept cache); the
  evaluation path (``eval_eat_now``, ``reason_with_trace``) on a started
  state against the JAX engine, and ``rollout_answers``.
* ``serve()`` (either loop), the proxy tier and the launcher refuse an
  encoder-decoder, naming ``start(frames=)``.
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
from repro.models import attention as jatt
from repro.models import transformer as jtfm
from repro.serving.cache import CacheConfig as JCache
from repro.serving.cache import alloc_cache as jalloc
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReasoningEngine as JEngine
from repro.serving.sampler import SamplerConfig as JSampler
from repro.sharding.partition import ShardCtx
from repro.training.checkpoint import save_checkpoint as jsave
from repro.utils.treeutil import tree_flatten_with_paths as jflatten
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as att
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model, build_params
from repro_torch.params import from_jax, param_specs, to_jax
from repro_torch.serving.cache import CacheConfig, alloc_cache, alloc_paged_cache
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.proxy import ProxyConfig
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.utils.treeutil import param_count, tree_flatten_with_paths

from _torch_threads import _one_thread  # noqa: F401

NAME = "seamless-m4t-large-v2"
FIELDS = ("name", "arch_type", "source", "n_layers", "n_encoder_layers",
          "encoder_len", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab", "activation", "qk_norm", "attn_bias", "tie_embeddings",
          "embed_scale", "rmsnorm_one_plus", "norm_eps", "rope_theta",
          "logit_softcap", "sliding_window", "attn_temperature", "dtype")
PUBLISHED = dict(n_layers=24, n_encoder_layers=24, encoder_len=1024, d_model=1024,
                 n_heads=16, n_kv_heads=16, resolved_head_dim=64, d_ff=8192,
                 vocab=256_206, padded_vocab=256_256, activation="gelu",
                 tie_embeddings=False, arch_type="encdec")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


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
    assert (red.n_layers, red.n_encoder_layers, red.encoder_len, red.d_model,
            red.head_dim, red.vocab, red.dtype) == (2, 2, 32, 128, 32, 512, "float32")


def test_param_specs_are_the_references_at_full_width():
    """Paths, shapes and dtypes of every leaf at full width with the depth
    cut to 2 + 2 (abstract on both sides: nothing allocated); the port's
    leaf count over its tree is the reference's."""
    cut = dict(n_layers=2, n_encoder_layers=2)
    jcfg, cfg = (dataclasses.replace(c, **cut) for c in (jget(NAME), get_config(NAME)))
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    ref = {path: (tuple(s.shape), s.dtype.name) for path, s in jflatten(shapes)}
    assert param_specs(cfg) == ref
    assert {"stack/enc_norm", "stack/dec_layers/norm_c", "stack/dec_layers/cross/wq",
            "stack/enc_layers/attn/wq", "embed/lm_head"} <= set(ref)
    assert ref["stack/enc_layers/ffn/w_up"][0] == (2, 1024, 8192)
    meta = build_params(cfg, None, torch.device("meta"))
    assert param_count(meta) == sum(int(np.prod(s)) for s, _ in ref.values())


def _pair(seed=11):
    jcfg, cfg = jget(NAME).reduced(), get_config(NAME).reduced()
    jmodel = JModel(jcfg, attn_impl="xla")
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, cfg, params


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _frames(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((B, cfg.encoder_len, cfg.d_model))).astype(np.float32)


def test_param_layout_round_trips_and_checkpoint_bytes(pair, tmp_path):
    _, jparams, cfg, params = pair
    ref = dict(jflatten(jparams))
    back = dict(tree_flatten_with_paths(to_jax(params, cfg)))
    assert sorted(back) == sorted(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(back[path].numpy(), np.asarray(leaf), err_msg=path)
    assert len(params["layers"]) == len(params["enc_layers"]) == 2
    jsave(str(tmp_path / "ref.ckpt"), jparams)
    save_checkpoint(str(tmp_path / "port.ckpt"), params, cfg)
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "ref.ckpt").read_bytes()


def test_encode_and_cross_attention_match_jax(pair):
    """The encoder over 32 frames; then a decoder layer's cross K/V from its
    output and cross-attention at m 1 and m S (every query at position 0,
    not causal), the last frames of row 1 invalid (position -1)."""
    jm, jparams, cfg, params = pair
    B, T = 2, cfg.encoder_len
    fr = _frames(cfg, B, 1)
    enc_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    jenc = jtfm.encode(jparams["stack"], jnp.asarray(fr), jnp.asarray(enc_pos),
                       jm.cfg, ShardCtx(mesh=None), attn_impl="xla")
    tm = Model(cfg, params)
    tenc = tfm.encode(tm.enc_layers, tm.enc_norm, torch.from_numpy(fr),
                      torch.from_numpy(enc_pos.copy()), cfg, attn_impl="auto")
    np.testing.assert_allclose(_np(tenc), _np(jenc), rtol=1e-5, atol=1e-5)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["stack"]["dec_layers"]["cross"])
    tp = params["layers"][0]["cross"]
    jk, jv = jatt.cross_attn_kv(jp, jenc, jm.cfg)
    tk, tv = att.cross_attn_kv(tp, tenc, cfg)
    np.testing.assert_allclose(_np(tk), _np(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-5, atol=1e-5)
    # a decoder block over a full sequence, its cross K/V made from the
    # encoder's output in the call (the reference's training block)
    S = 12
    x = np.random.default_rng(2).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jx, _ = jtfm.attn_block_full(
        jax.tree_util.tree_map(lambda a: a[0], jparams["stack"]["dec_layers"]),
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(pos), jm.cfg, ShardCtx(mesh=None),
        use_moe=False, enc_kv=jenc, enc_pos=jnp.asarray(enc_pos), attn_impl="xla")
    tx, _ = tfm.attn_block_full(params["layers"][0], torch.from_numpy(x),
                                torch.from_numpy(pos), torch.from_numpy(pos), cfg,
                                enc_kv=tenc, enc_pos=torch.from_numpy(enc_pos.copy()))
    np.testing.assert_allclose(_np(tx), _np(jx), rtol=1e-5, atol=1e-5)
    epos = enc_pos.copy()
    epos[1, T - 5:] = -1
    for S in (1, 12):
        x = np.random.default_rng(S).standard_normal((B, S, cfg.d_model)).astype(np.float32)
        jy = jatt.cross_attention(jp, jnp.asarray(x), jk, jv, jnp.asarray(epos), jm.cfg,
                                  attn_impl="xla")
        ty = att.cross_attention(tp, torch.from_numpy(x), tk, tv, torch.from_numpy(epos),
                                 cfg)
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-5, atol=1e-5, err_msg=str(S))


def _port_cache(cfg, kind, B, C):
    if kind == "ring":
        return alloc_cache(cfg, B, C, device="cpu")
    cache = alloc_paged_cache(cfg, B, C, 4, 1 + B * C // 4, device="cpu")
    # every row's blocks mapped to pages of its own, in a shuffled order
    pages = np.random.default_rng(1).permutation(B * C // 4) + 1
    cache["page_table"].copy_(torch.from_numpy(pages.reshape(B, C // 4).astype(np.int32)))
    return cache


def _fixed(cache):
    """What a probe must leave as it was: the cross K/V, enc_pos, pos, cur."""
    out = [cache["enc_pos"].clone(), cache["pos"].clone(), cache["cur"].clone()]
    for e in cache["layers"]:
        out += [e["ck"].clone(), e["cv"].clone()]
    return out


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("S", [12, 20])
def test_prefill_decode_probe_match_jax(pair, kind, S):
    """A left-padded prefill of S tokens with frames (and its logits), one
    decode step and a 2-token probe, port against reference, within 1e-5;
    the probe changes none of the cache's fixed parts."""
    jm, jparams, cfg, params = pair
    tm = Model(cfg, params)
    B, pad = 2, 4
    rng = np.random.default_rng(S)
    toks = rng.integers(4, cfg.vocab, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, :pad], pos[1, pad:], toks[1, :pad] = -1, np.arange(S - pad), 0
    fr = _frames(cfg, B, S)
    jcache, tcache = jalloc(jm.cfg, B, 32), _port_cache(cfg, kind, B, 32)
    jh, jcache = jm.prefill(jparams, jnp.asarray(toks), jnp.asarray(pos),
                            jnp.asarray(pos), jcache, frames=jnp.asarray(fr))
    th = tm.prefill(torch.from_numpy(toks).long(), torch.from_numpy(pos),
                    torch.from_numpy(pos), tcache, frames=torch.from_numpy(fr))
    np.testing.assert_allclose(_np(th), _np(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tm.logits(th[:, -1:])),
                               _np(jm.logits(jparams, jh[:, -1:])), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tcache["layers"][1]["ck"]),
                               _np(jcache["layers"]["dec_seg"]["ck"][1]),
                               rtol=1e-5, atol=1e-5)
    nxt, p1 = np.array([[7], [9]], np.int32), np.array([[S], [S - pad]], np.int32)
    jl, jcache = jm.decode_step(jparams, jnp.asarray(nxt), jnp.asarray(p1),
                                jnp.asarray(p1), jcache)
    tl = tm.decode_step(torch.from_numpy(nxt).long(), torch.from_numpy(p1),
                        torch.from_numpy(p1), tcache)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=1e-5)
    probe = np.array([[1, 6]] * 2, np.int32)
    pp = p1 + 1 + np.arange(2, dtype=np.int32)[None]
    before = _fixed(tcache)
    je = jm.probe_entropy(jparams, jnp.asarray(probe), jnp.asarray(pp),
                          jnp.asarray(pp), jcache, entropy_impl="xla")
    te = tm.probe_entropy(torch.from_numpy(probe).long(), torch.from_numpy(pp),
                          torch.from_numpy(pp), tcache)
    np.testing.assert_allclose(_np(te), _np(je), rtol=1e-5, atol=1e-5)
    assert bool(torch.isfinite(te).all())
    for a, b in zip(before, _fixed(tcache)):
        assert torch.equal(a, b)


def test_prefill_without_frames_is_refused(pair):
    _, _, cfg, params = pair
    cache = alloc_cache(cfg, 1, 16, device="cpu")
    toks, pos = torch.arange(4, 8).long()[None], torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="frames"):
        Model(cfg, params).prefill(toks, pos, pos, cache)


# ----------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def batch():
    return ChainTask().serve_batch(np.random.default_rng(7), 4)


def _ecfg(cls, sampler, cache):
    return cls(max_reasoning_tokens=24, capacity=96, pad_id=Tokens.PAD,
               end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
               eos_id=Tokens.EOS, chunk_len=4, sampler=sampler(greedy=True),
               cache=cache)


def _mon(cls_mon, cls_stop, probe, delta=1e9):
    return cls_mon(stopper=cls_stop(alpha=0.2, delta=delta),
                   probe=probe(Tokens.END_THINK, (Tokens.ANS,)),
                   schedule="every_n", every_n=4, min_evals=2)


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


def _port_engine(model):
    return ReasoningEngine(model, _ecfg(EngineConfig, SamplerConfig,
                                        CacheConfig(kind="ring", attn_impl="auto")),
                           _mon(ReasoningMonitor, EATStopper, make_probe))


def test_start_reason_force_answer_match_jax_engine(pair, batch):
    """The reference's entry points for this family on the same weights,
    frames and prompts (a ring cache, the page-native block read, a probe
    every 4 tokens, exit at the 2nd evaluation): every row exits by EAT with
    the reference's tokens and answers; a second start() on the engine with
    other frames gives a new engine's results."""
    jmodel, jparams, cfg, params = pair
    B = batch["prompts"].shape[0]
    fr = _frames(cfg, B, 5)
    jeng = JEngine(jmodel, jparams, _ecfg(JEngineConfig, JSampler,
                                         JCache(kind="ring", attn_impl="xla")),
                   _mon(JMonitor, JStopper, jprobe))
    jtrace = []
    _traced(jeng.executor, jtrace)
    jst = jeng.start(jnp.asarray(batch["prompts"]), jnp.asarray(batch["prompt_len"]),
                     jax.random.PRNGKey(0), frames=jnp.asarray(fr))
    jst = jeng.reason(jst)
    jans, _ = jeng.force_answer(jst, 4, greedy=True)

    model = Model(cfg, params)
    eng = _port_engine(model)
    trace = []
    _traced(eng.executor, trace)
    st = eng.reason(eng.start(batch["prompts"], batch["prompt_len"], None, frames=fr))
    ans, _ = eng.force_answer(st, 4, greedy=True)
    assert _exits(st) == _exits(jst)
    assert {why for _, why in _exits(st)} == {"eat"}
    np.testing.assert_array_equal(ans.numpy(), np.asarray(jans))
    assert len(trace) == len(jtrace) >= 2
    for t, j in zip(trace, jtrace):
        assert t[:2] == j[:2]
        np.testing.assert_allclose(t[2:], j[2:], rtol=1e-5, atol=1e-5)

    # the engine again, other frames: its kept cache gets the new cross K/V
    fr2 = _frames(cfg, B, 6)
    st2 = eng.reason(eng.start(batch["prompts"], batch["prompt_len"], None, frames=fr2))
    ans2, _ = eng.force_answer(st2, 4, greedy=True)
    new = _port_engine(model)
    st3 = new.reason(new.start(batch["prompts"], batch["prompt_len"], None, frames=fr2))
    ans3, _ = new.force_answer(st3, 4, greedy=True)
    assert _exits(st2) == _exits(st3) and torch.equal(ans2, ans3)
    assert torch.equal(st2.monitor.stop_state.ema.var, st3.monitor.stop_state.ema.var)


def test_evaluation_path_matches_jax_engine_on_a_started_state(pair, batch):
    """``eval_eat_now`` after ``start(frames=)`` and ``reason_with_trace``
    (12 tokens, no rollouts) against the JAX engine: records' token counts
    and due rows exactly, EAT and the EMA variance within 1e-5; the port's
    sampled ``rollout_answers`` on a started state: (K, B, n)."""
    jmodel, jparams, cfg, params = pair
    B = batch["prompts"].shape[0]
    fr = _frames(cfg, B, 7)
    jeng = JEngine(jmodel, jparams, _ecfg(JEngineConfig, JSampler,
                                         JCache(kind="ring", attn_impl="xla")),
                   _mon(JMonitor, JStopper, jprobe))
    eng = _port_engine(Model(cfg, params))
    args = (batch["prompts"], batch["prompt_len"])
    jst = jeng.start(*map(jnp.asarray, args), jax.random.PRNGKey(0), frames=jnp.asarray(fr))
    st = eng.start(*args, None, frames=fr)
    np.testing.assert_allclose(_np(eng.eval_eat_now(st)), _np(jeng.eval_eat_now(jst)),
                               rtol=1e-5, atol=1e-5)
    _, jrecs = jeng.reason_with_trace(jst, max_tokens=12)
    _, recs = eng.reason_with_trace(st, max_tokens=12)
    assert len(recs) == len(jrecs) >= 2
    for r, j in zip(recs, jrecs):
        for k in ("n_tokens", "due"):
            np.testing.assert_array_equal(np.asarray(r[k]), np.asarray(j[k]), err_msg=k)
        for k in ("eat", "ema_var"):
            np.testing.assert_allclose(_np(r[k]), _np(j[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    rolls = eng.rollout_answers(eng.start(*args, None, frames=fr), 2, 3,
                                torch.Generator().manual_seed(0))
    assert tuple(rolls.shape) == (2, B, 3)


def test_serve_proxy_and_launcher_refuse_encdec(pair, batch):
    _, _, cfg, params = pair
    model = Model(cfg, params)
    eng = _port_engine(model)
    for overlap in (False, True):
        with pytest.raises(ValueError, match=r"start\(prompts, prompt_len, frames"):
            eng.serve(batch["prompts"], batch["prompt_len"], None, batch_size=2,
                      overlap=overlap)
    with pytest.raises(ValueError, match="proxy tier"):
        ReasoningEngine(model, _ecfg(EngineConfig, SamplerConfig, CacheConfig()),
                        _mon(ReasoningMonitor, EATStopper, make_probe),
                        proxy=ProxyConfig(model=model))
    with pytest.raises(ValueError, match=r"frames=\.\.\."):
        serve_cli.main(["--device", "cpu", "--arch", NAME, "--requests", "2"])
