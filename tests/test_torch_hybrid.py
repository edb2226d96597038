"""The port's hybrid family (``zamba2-2.7b``: Mamba2 blocks and one shared
attention block) against the JAX reference on the CPU (float32; the
config's ``reduced()`` on both sides, one group of 5 SSM blocks and the
shared block, and the same with ``n_layers = 12``: two groups, so two
applications of the shared block with distinct K/V entries; parameters
carried by ``params.from_jax``).

* The config equals the reference's field by field, with the published
  hyperparameters spot checked; ``param_specs`` gives the reference's leaf
  paths, shapes and dtypes at full width (depth cut to 12): the SSM leaves
  under ``stack/groups`` with two leading axes ``(G, n_per)``, the shared
  block under ``stack/shared_attn`` with none and a 2 d wide ``norm1``
  and q/k/v input.
* ``prefill`` (and its logits), ``decode_step`` and ``probe_entropy``
  against the JAX ``Model`` within 1e-5, on a ring and a paged cache, with
  a prompt of 12 tokens (the SSM blocks' step recurrence) and of 20 (the
  chunked scan).
* The paged self-EAT serve against the JAX engine: tokens, exits, exit
  reasons and answers exactly, EAT traces within 1e-5 (prompts left-padded
  to 40 tokens, past the scan switch); ring == paged bitwise inside the
  port.
* Across a decode chunk, an inactive row's SSM states stay bitwise while an
  active row's move; the attention entries are never frozen (the same
  tensors, written in place: a page pool has no row axis).
* ``to_jax(from_jax(p))`` is ``p`` leaf for leaf, and a port checkpoint is
  the reference's file byte for byte.
* ``train_loss`` and every gradient leaf against ``jax.value_and_grad``
  within 1e-5.
* A reduced zamba2 proxy shadowing a reduced dense generator of the same
  vocabulary (``qwen3-1.7b``) against the JAX engine; a hybrid generator
  is refused a proxy tier; the launcher accepts ``--arch zamba2-2.7b
  --cache paged``.
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
from repro.serving.cache import CacheConfig as JCache
from repro.serving.cache import alloc_cache as jalloc
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReasoningEngine as JEngine
from repro.serving.proxy import ProxyConfig as JProxyConfig
from repro.serving.sampler import SamplerConfig as JSampler
from repro.training.checkpoint import save_checkpoint as jsave
from repro.utils.treeutil import tree_flatten_with_paths as jflatten
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.data.pipeline import device_put_batch
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import Model, train_loss
from repro_torch.params import from_jax, param_specs, to_jax
from repro_torch.serving.cache import (CacheConfig, alloc_cache, alloc_paged_cache,
                                       freeze_inactive_rows)
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.proxy import ProxyConfig
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.train_loop import trainable
from repro_torch.utils.treeutil import tree_flatten_with_paths, tree_leaves, tree_map

from _torch_threads import _one_thread  # noqa: F401
from test_torch_moe import _np, _rebuild

NAME = "zamba2-2.7b"
FIELDS = ("name", "arch_type", "source", "n_layers", "d_model", "n_heads",
          "n_kv_heads", "head_dim", "d_ff", "vocab", "activation", "qk_norm",
          "attn_bias", "tie_embeddings", "embed_scale", "rmsnorm_one_plus",
          "norm_eps", "rope_theta", "sliding_window", "hybrid_pattern", "dtype")
PUBLISHED = dict(n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
                 resolved_head_dim=80, d_ff=10240, vocab=32_000, padded_vocab=32_000,
                 tie_embeddings=False,
                 hybrid_pattern=("ssm",) * 5 + ("shared_attn",))
WIDTH = 40          # serve prompts left-padded past the m > 16 scan switch


def _reduced(n_layers=None):
    """The reduced config in both packages, ``n_layers`` deep if given."""
    jcfg, cfg = jget(NAME).reduced(), get_config(NAME).reduced()
    if n_layers:
        jcfg, cfg = (dataclasses.replace(c, n_layers=n_layers) for c in (jcfg, cfg))
    return jcfg, cfg


def _pair(jcfg, cfg, seed=11):
    jmodel = JModel(jcfg, attn_impl="xla")
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, cfg, params


@pytest.fixture(scope="module", params=[6, 12], ids=["one-group", "two-groups"])
def pair(request):
    return _pair(*_reduced(request.param))


# ------------------------------------------------------------------ config


def test_config_matches_reference_and_publication():
    for ref, mine in ((jget(NAME), get_config(NAME)),
                      (jget(NAME).reduced(), get_config(NAME).reduced())):
        for f in FIELDS:
            assert getattr(mine, f) == getattr(ref, f), f
        assert dataclasses.asdict(mine.ssm) == dataclasses.asdict(ref.ssm)
        assert mine.moe is mine.mla is None
        assert mine.block_kinds() == ref.block_kinds()
    for f, want in PUBLISHED.items():
        assert getattr(get_config(NAME), f) == want, f
    cfg = get_config(NAME)
    assert (cfg.ssm.d_state, cfg.ssm.head_dim, cfg.ssm.expand, cfg.ssm.chunk) == \
        (64, 64, 2, 128)
    assert cfg.block_kinds().count("ssm") == 45
    assert cfg.block_kinds().count("shared_attn") == 9
    assert get_config(NAME).reduced().n_layers == 6


def test_param_specs_are_the_references_at_full_width():
    """Paths, shapes and dtypes of every leaf at full width, two groups deep
    (abstract on both sides: nothing allocated)."""
    jcfg, cfg = (dataclasses.replace(c, n_layers=12) for c in (jget(NAME), get_config(NAME)))
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    ref = {path: (tuple(s.shape), s.dtype.name) for path, s in jflatten(shapes)}
    specs = param_specs(cfg)
    assert specs == ref
    d = cfg.d_model
    assert specs["stack/groups/ssm/w_x"] == ((2, 5, d, 2 * d), "bfloat16")
    assert specs["stack/shared_attn/norm1"] == ((2 * d,), "bfloat16")
    assert specs["stack/shared_attn/attn/wq"] == ((2 * d, 32 * 80), "bfloat16")
    assert specs["stack/shared_attn/attn/wo"] == ((32 * 80, d), "bfloat16")
    assert specs["stack/shared_attn/ffn/w_up"] == ((d, 10240), "bfloat16")


def test_param_layout_round_trips(pair):
    _, jparams, cfg, params = pair
    ref = dict(jflatten(jparams))
    back = dict(tree_flatten_with_paths(to_jax(params, cfg)))
    assert sorted(back) == sorted(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(back[path].numpy(), np.asarray(leaf), err_msg=path)
    G = cfg.n_layers // 6
    assert len(params["layers"]) == 5 * G
    assert back["stack/groups/norm"].shape[:2] == (G, 5)


def test_checkpoint_is_the_references_bytes(pair, tmp_path):
    _, jparams, cfg, params = pair
    jsave(str(tmp_path / "ref.ckpt"), jparams)
    save_checkpoint(str(tmp_path / "port.ckpt"), params, cfg)
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "ref.ckpt").read_bytes()


# ------------------------------------------------------- model against JAX


def _port_cache(cfg, kind, B, C):
    if kind == "ring":
        return alloc_cache(cfg, B, C, device="cpu")
    cache = alloc_paged_cache(cfg, B, C, 4, 1 + B * C // 4, device="cpu")
    # every row's blocks mapped to pages of its own, in a shuffled order
    pages = np.random.default_rng(1).permutation(B * C // 4) + 1
    cache["page_table"].copy_(torch.from_numpy(pages.reshape(B, C // 4).astype(np.int32)))
    return cache


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("S", [12, 20], ids=["step", "scan"])
def test_prefill_decode_probe_match_jax(pair, kind, S):
    """A left-padded prefill of S tokens (and its logits), one decode step
    and a 2-token probe, port against reference, within 1e-5; the probe
    leaves the port's cache as it was."""
    jm, jparams, cfg, params = pair
    tm = Model(cfg, params)
    B, pad = 2, 4
    rng = np.random.default_rng(S)
    toks = rng.integers(4, cfg.vocab, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, :pad], pos[1, pad:], toks[1, :pad] = -1, np.arange(S - pad), 0
    jcache, tcache = jalloc(jm.cfg, B, 32), _port_cache(cfg, kind, B, 32)
    jh, jcache = jm.prefill(jparams, jnp.asarray(toks), jnp.asarray(pos),
                            jnp.asarray(pos), jcache)
    th = tm.prefill(torch.from_numpy(toks).long(), torch.from_numpy(pos),
                    torch.from_numpy(pos), tcache)
    np.testing.assert_allclose(_np(th), _np(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tm.logits(th[:, -1:])),
                               _np(jm.logits(jparams, jh[:, -1:])), rtol=1e-5, atol=1e-5)
    nxt, p1 = np.array([[7], [9]], np.int32), np.array([[S], [S - pad]], np.int32)
    jl, jcache = jm.decode_step(jparams, jnp.asarray(nxt), jnp.asarray(p1),
                                jnp.asarray(p1), jcache)
    tl = tm.decode_step(torch.from_numpy(nxt).long(), torch.from_numpy(p1),
                        torch.from_numpy(p1), tcache)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=1e-5)
    probe = np.array([[1, 6]] * 2, np.int32)
    pp = p1 + 1 + np.arange(2, dtype=np.int32)[None]
    before = [t.clone() for t in tree_leaves(tcache["layers"])]
    je = jm.probe_entropy(jparams, jnp.asarray(probe), jnp.asarray(pp),
                          jnp.asarray(pp), jcache, entropy_impl="xla")
    te = tm.probe_entropy(torch.from_numpy(probe).long(), torch.from_numpy(pp),
                          torch.from_numpy(pp), tcache)
    np.testing.assert_allclose(_np(te), _np(je), rtol=1e-5, atol=1e-5)
    assert bool(torch.isfinite(te).all())
    for a, b in zip(before, tree_leaves(tcache["layers"])):
        assert torch.equal(a, b)


def test_two_applications_write_distinct_entries():
    """The shared block's applications share weights but not K/V: after a
    prefill, the two attention entries of a two-group cache differ."""
    _, _, cfg, params = _pair(*_reduced(12), seed=3)
    cache = alloc_cache(cfg, 1, 16, device="cpu")
    toks = torch.arange(4, 12).long()[None]
    pos = torch.arange(8, dtype=torch.int32)[None]
    Model(cfg, params).prefill(toks, pos, pos, cache)
    attn = [e for e in cache["layers"] if "k" in e]
    assert len(attn) == 2 and len(cache["layers"]) == 12
    assert not torch.equal(attn[0]["k"][:, :8], attn[1]["k"][:, :8])


# ----------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def batch():
    b = ChainTask().serve_batch(np.random.default_rng(7), 6)
    pad = WIDTH - b["prompts"].shape[1]
    b["prompts"] = np.pad(b["prompts"], ((0, 0), (pad, 0)), constant_values=Tokens.PAD)
    return b


def _ecfg(cls, sampler, cache, capacity=256):
    return cls(max_reasoning_tokens=24, capacity=capacity, pad_id=Tokens.PAD,
               end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
               eos_id=Tokens.EOS, chunk_len=8, sampler=sampler(greedy=True),
               cache=cache)


def _mon(cls_mon, cls_stop, probe, delta):
    return cls_mon(stopper=cls_stop(alpha=0.2, delta=delta),
                   probe=probe(Tokens.END_THINK, (Tokens.ANS,)),
                   schedule="every_n", every_n=4, min_evals=1)


def _jax_serve(jmodel, jparams, b, delta, proxy=None):
    eng = JEngine(jmodel, jparams,
                  _ecfg(JEngineConfig, JSampler,
                        JCache(kind="paged", page_size=16, attn_impl="xla")),
                  _mon(JMonitor, JStopper, jprobe, delta), proxy=proxy)
    return eng.serve(b["prompts"], b["prompt_len"], jax.random.PRNGKey(0),
                     batch_size=4, max_tokens=24, answer_len=4, record_trace=True)


def _engine(model, delta, *, kind="paged", proxy=None):
    return ReasoningEngine(
        model, _ecfg(EngineConfig, SamplerConfig,
                     CacheConfig(kind=kind, page_size=16, attn_impl="auto")),
        _mon(ReasoningMonitor, EATStopper, make_probe, delta), proxy=proxy)


def _serve(model, b, delta, *, kind="paged", proxy=None):
    return _engine(model, delta, kind=kind, proxy=proxy).serve(
        b["prompts"], b["prompt_len"], None, batch_size=4, max_tokens=24,
        answer_len=4, record_trace=True)


def _assert_matches_jax(ref, out):
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


@pytest.fixture(scope="module")
def paged_serve(pair, batch):
    _, _, cfg, params = pair
    model = Model(cfg, params)
    return model, _serve(model, batch, 1e9)


def test_paged_serve_matches_jax(pair, batch, paged_serve):
    """At delta 1e9 every request exits by EAT at its 2nd evaluation; 6
    requests through 4 slots, so two admissions run."""
    jmodel, jparams, _, _ = pair
    _, out = paged_serve
    _assert_matches_jax(_jax_serve(jmodel, jparams, batch, 1e9), out)
    assert {o["exit_reason"] for o in out} == {"eat"}
    assert len({o["slot"] for o in out}) < len(out)


def test_paged_equals_ring_bitwise(paged_serve, batch):
    model, paged = paged_serve
    ring = _serve(model, batch, 1e9, kind="ring")
    for p, r in zip(paged, ring):
        assert (p["n_reasoning"], p["exit_reason"], p["ended_think"]) == \
               (r["n_reasoning"], r["exit_reason"], r["ended_think"])
        np.testing.assert_array_equal(p["reasoning_tokens"], r["reasoning_tokens"])
        np.testing.assert_array_equal(p["answer_tokens"], r["answer_tokens"])
        assert p["eat_trace"] == r["eat_trace"]


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_inactive_row_states_frozen_attention_not(pair, batch, kind):
    """One decode chunk with row 1 inactive: its SSM states bitwise, an
    active row's moved; every attention entry is the same tensors before
    and after (written in place, never frozen or replaced; the eager chunk
    replaces the SSM entries, a graph chunk copies them back)."""
    _, _, cfg, params = pair
    eng = _engine(Model(cfg, params), 0.0, kind=kind)
    B = 3
    toks = np.random.default_rng(2).integers(4, cfg.vocab, size=(B, 24))
    ss = eng._serve_setup(toks, np.full(B, 24), None, batch_size=B, max_tokens=16,
                          chunk_len=4)
    state = eng.executor.decode_chunk(ss.state, 16, 4)
    state.active[1] = False
    layers = list(state.cache["layers"])
    before = [[t.clone() for t in tree_leaves(e)] for e in layers]
    attn_k = [e["k"].clone() for e in layers if "k" in e]
    state = eng.executor.decode_chunk(state, 16, 4)
    for e, old, new in zip(layers, before, state.cache["layers"]):
        if "ssm" not in e:
            assert new is e
            continue
        for a, b in zip(old, tree_leaves(new)):
            assert torch.equal(a[1], b[1])
            assert not torch.equal(a[0], b[0])
    ks = [e["k"] for e in state.cache["layers"] if "k" in e]
    assert len(ks) == cfg.n_layers // 6
    assert all(not torch.equal(a, b) for a, b in zip(attn_k, ks))


def test_freeze_passes_attention_entries_through():
    cfg = get_config(NAME).reduced()
    old = alloc_paged_cache(cfg, 2, 16, 4, 9, device="cpu")["layers"]
    new = [tree_map(lambda t: t + 1, e) if "ssm" in e else e for e in old]
    cache = {"layers": list(new)}
    freeze_inactive_rows(cache, old, torch.tensor([True, False]))
    for f, n, o in zip(cache["layers"], new, old):
        if "ssm" not in o:
            assert f is n is o
            continue
        for a, b, c in zip(tree_leaves(f), tree_leaves(n), tree_leaves(o)):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], c[1])



# ------------------------------------------------------------------ proxy


def test_hybrid_proxy_shadowing_a_dense_generator_matches_jax(batch):
    """Reduced zamba2 (one group) monitoring reduced qwen3-1.7b (the same
    512-token vocabulary), paged, against the JAX engine."""
    jgen, jgp, gcfg, gparams = _pair(jget("qwen3-1.7b").reduced(),
                                     get_config("qwen3-1.7b").reduced(), seed=4)
    jprx, jpp, pcfg, pparams = _pair(*_reduced(), seed=5)
    assert gcfg.vocab == pcfg.vocab
    ref = _jax_serve(jgen, jgp, batch, 0.2, proxy=JProxyConfig(model=jprx, params=jpp))
    out = _serve(Model(gcfg, gparams), batch, 0.2,
                 proxy=ProxyConfig(model=Model(pcfg, pparams)))
    _assert_matches_jax(ref, out)


def test_hybrid_generator_refuses_a_proxy(pair):
    _, _, cfg, params = pair
    model = Model(cfg, params)
    with pytest.raises(ValueError, match="SSM/hybrid"):
        _engine(model, 1e9, proxy=ProxyConfig(model=model))


def test_serve_cli_accepts_the_arch(monkeypatch):
    """``--arch zamba2-2.7b --cache paged`` passes the launcher's checks; the
    run is stopped where it would pick the device and allocate the
    full-width model."""
    seen = {}

    def stop(device):
        seen["device"] = device
        raise SystemExit(0)

    monkeypatch.setattr(serve_cli, "resolve_device", stop)
    for cache in ("paged", "ring"):
        with pytest.raises(SystemExit):
            serve_cli.main(["--arch", NAME, "--cache", cache, "--requests", "8"])
    assert seen == {"device": "cuda"}


# ---------------------------------------------------------------- training


def test_train_loss_and_grads_match_jax(pair):
    jmodel, jparams, cfg, _ = pair
    b = ChainTask(seq_len=40).batch(np.random.default_rng(0), 4)
    jf = lambda p: jmodel.train_loss(  # noqa: E731
        p, {k: jnp.asarray(v) for k, v in b.items()}, remat=False)
    (_, jm), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jparams)
    tp = trainable(from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu"))
    loss, m = train_loss(tp, cfg, device_put_batch(b, "cpu"), remat=True)
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
    assert float(g["stack/shared_attn/attn/wq"].abs().max()) > 0
    assert float(g["stack/groups/ssm/w_x"].abs().max()) > 0


# ---------------------------------------------- the flash-decode op at 256


@pytest.mark.parametrize("Hq,Hkv,m", [(4, 4, 1), (8, 1, 2), (8, 1, 8)],
                         ids=["g1-m1", "g8-m2", "g8-m8"])
def test_decode_op_plain_at_head_dim_256_matches_jax(Hq, Hkv, m):
    """The flash-decode op's plain version at Gemma's (256, 256), g 1 and
    8, against the JAX op's own dispatch, within 1e-5 in float32 (the CUDA
    op, which now takes head dims up to 256, is held to this plain version
    on the card)."""
    from repro.kernels.decode_attention.ops import decode_attention as jdecode
    from repro_torch.kernels.decode_attention import ops as da

    rng = np.random.default_rng(m)
    B, C = 2, 600
    q = rng.normal(size=(B, m, Hq, 256)).astype(np.float32)
    k = rng.normal(size=(B, C, Hkv, 256)).astype(np.float32)
    v = rng.normal(size=(B, C, Hkv, 256)).astype(np.float32)
    qp = np.broadcast_to(np.arange(m) + 500, (B, m)).astype(np.int32)
    kp = np.broadcast_to(np.arange(C), (B, C)).astype(np.int32).copy()
    kp[:, -37:] = -1
    assert da.MAX_HEAD_DIM == 256
    out = da.decode_attention(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in (q, k, v, qp, kp)))
    ref = jdecode(*(jnp.asarray(a) for a in (q, k, v, qp, kp)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
