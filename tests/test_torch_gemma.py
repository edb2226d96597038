"""The dense Gemma and CodeQwen configs of the port against the JAX
reference on the CPU (float32; each config's ``reduced()`` on both sides,
the parameters carried by ``params.from_jax``).

* The three configs (``gemma-2b``, ``gemma-7b``, ``codeqwen1.5-7b``) equal
  the reference's field by field, with the published hyperparameters spot
  checked (head dim 256, tied table, padded vocab 256,000 for Gemma; qkv
  bias and rope theta 1e6 for CodeQwen); ``param_specs`` gives the
  reference's leaf paths, shapes and dtypes at full width (depth cut to 2).
* Each reduced config: ``prefill`` (and its logits), ``decode_step`` and
  ``probe_entropy`` against the JAX ``Model`` within 1e-5; the paged
  self-EAT serve against the JAX engine (tokens, exits and answers
  exactly, EAT traces within 1e-5); ``train_loss`` and every gradient leaf
  against ``jax.value_and_grad`` within 1e-5 (Gemma's tied table and
  ``embed_scale`` among them).
* Gemma's real head dim: the reduced Gemma config with ``head_dim=256``
  and g 2 on both sides, through prefill, decode and probe on a ring and a
  paged cache, within 1e-5: the port's plain path at head dim 256.
* ``launch.serve`` accepts ``--arch gemma-2b|gemma-7b|codeqwen1.5-7b``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import Model as JModel
from repro.serving.cache import alloc_cache as jalloc
from repro.utils.treeutil import tree_flatten_with_paths as jflatten
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import device_put_batch
from repro_torch.data.synthetic import ChainTask
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import Model, train_loss
from repro_torch.params import from_jax, param_specs, to_jax
from repro_torch.serving.cache import alloc_cache, alloc_paged_cache
from repro_torch.training.train_loop import trainable
from repro_torch.utils.treeutil import tree_flatten_with_paths, tree_leaves

from _torch_threads import _one_thread  # noqa: F401
from test_torch_moe import _jax_serve, _np, _rebuild, _serve

NAMES = ["gemma-2b", "gemma-7b", "codeqwen1.5-7b"]
FIELDS = ("name", "arch_type", "source", "n_layers", "d_model", "n_heads",
          "n_kv_heads", "head_dim", "d_ff", "vocab", "activation", "qk_norm",
          "attn_bias", "tie_embeddings", "embed_scale", "rmsnorm_one_plus",
          "norm_eps", "rope_theta", "logit_softcap", "sliding_window",
          "attn_temperature", "dtype")
PUBLISHED = {
    "gemma-2b": dict(n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
                     resolved_head_dim=256, d_ff=16384, vocab=256_000,
                     padded_vocab=256_000, activation="geglu", tie_embeddings=True,
                     embed_scale=True, rmsnorm_one_plus=True, attn_bias=False),
    "gemma-7b": dict(n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
                     resolved_head_dim=256, d_ff=24576, vocab=256_000,
                     padded_vocab=256_000, activation="geglu", tie_embeddings=True,
                     embed_scale=True, rmsnorm_one_plus=True, attn_bias=False),
    "codeqwen1.5-7b": dict(n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
                           resolved_head_dim=128, d_ff=13440, vocab=92_416,
                           padded_vocab=92_416, activation="silu",
                           tie_embeddings=False, embed_scale=False,
                           rmsnorm_one_plus=False, attn_bias=True,
                           rope_theta=1_000_000.0),
}


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference_and_publication(name):
    for ref, mine in ((jget(name), get_config(name)),
                      (jget(name).reduced(), get_config(name).reduced())):
        for f in FIELDS:
            assert getattr(mine, f) == getattr(ref, f), f
        assert mine.moe is mine.ssm is mine.mla is None
        assert (mine.resolved_head_dim, mine.padded_vocab) == \
            (ref.resolved_head_dim, ref.padded_vocab)
    for f, want in PUBLISHED[name].items():
        assert getattr(get_config(name), f) == want, f
    red = get_config(name).reduced()
    assert (red.n_layers, red.d_model, red.head_dim, red.vocab, red.dtype) == \
        (2, 128, 32, 512, "float32")


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_are_the_references_at_full_width(name):
    """Paths, shapes and dtypes of every leaf at full width with the depth
    cut to 2 layers (abstract on both sides: nothing allocated)."""
    jcfg, cfg = (dataclasses.replace(c, n_layers=2) for c in (jget(name), get_config(name)))
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    ref = {path: (tuple(s.shape), s.dtype.name) for path, s in jflatten(shapes)}
    assert param_specs(cfg) == ref
    assert ("embed/lm_head" in ref) == (not cfg.tie_embeddings)


def _pair(jcfg, cfg, seed=11):
    jmodel = JModel(jcfg, attn_impl="xla")
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, cfg, params


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    return _pair(jget(request.param).reduced(), get_config(request.param).reduced())


def _port_cache(cfg, kind, B, C):
    if kind == "ring":
        return alloc_cache(cfg, B, C, device="cpu")
    cache = alloc_paged_cache(cfg, B, C, 4, 1 + B * C // 4, device="cpu")
    # every row's blocks mapped to pages of its own, in a shuffled order
    pages = np.random.default_rng(1).permutation(B * C // 4) + 1
    cache["page_table"].copy_(torch.from_numpy(pages.reshape(B, C // 4).astype(np.int32)))
    return cache


def _prefill_decode_probe(pair, kind="ring"):
    """A left-padded prefill of 12 tokens (and its logits), one decode step
    and a 2-token probe, port against reference, within 1e-5."""
    jm, params, cfg, tparams = pair
    tm = Model(cfg, tparams)
    B, S = 2, 12
    rng = np.random.default_rng(0)
    toks = rng.integers(4, cfg.vocab, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, :4], pos[1, 4:], toks[1, :4] = -1, np.arange(S - 4), 0
    jcache, tcache = jalloc(jm.cfg, B, 32), _port_cache(cfg, kind, B, 32)
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
    assert bool(torch.isfinite(te).all())


def test_prefill_decode_probe_match_jax(pair):
    _prefill_decode_probe(pair)


@pytest.fixture(scope="module")
def batch():
    return ChainTask().serve_batch(np.random.default_rng(7), 6)


def test_paged_serve_matches_jax(pair, batch):
    """At delta 1e9 every request exits by EAT at its 2nd evaluation."""
    jmodel, jparams, cfg, params = pair
    ref = _jax_serve(jmodel, jparams, batch, 1e9)
    out = _serve(Model(cfg, params), batch, 1e9)
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
    assert {o["exit_reason"] for o in out} == {"eat"}


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
    for k in ("loss", "ce", "z_loss", "accuracy", "tokens"):
        np.testing.assert_allclose(_np(m[k]), _np(jm[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    jg = dict(jflatten(jg))
    assert sorted(jg) == sorted(g)
    for path, ref in jg.items():
        np.testing.assert_allclose(_np(g[path]), _np(ref), rtol=1e-5, atol=1e-5,
                                   err_msg=path)
    # the tied table takes the input embedding's and the unembedding's
    # gradients in one leaf; CodeQwen's qkv bias has its own
    assert ("embed/lm_head" in g) == (not cfg.tie_embeddings)
    assert float(g["embed/embedding"].abs().max()) > 0
    if cfg.attn_bias:
        assert float(g["stack/layers/attn/bq"].abs().max()) > 0


@pytest.fixture(scope="module", params=["gemma-2b", "gemma-7b"])
def wide_pair(request):
    """The reduced Gemma config at Gemma's head dim of 256, 4 q heads on 2
    kv heads (g 2), on both sides."""
    jcfg, cfg = (dataclasses.replace(c.reduced(), head_dim=256, n_heads=4, n_kv_heads=2)
                 for c in (jget(request.param), get_config(request.param)))
    return _pair(jcfg, cfg, seed=5)


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_head_dim_256_prefill_decode_probe_match_jax(wide_pair, kind):
    cfg = wide_pair[2]
    assert (cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads, cfg.n_layers) == \
        (256, 2, 2)
    _prefill_decode_probe(wide_pair, kind)


@pytest.mark.parametrize("name", NAMES)
def test_serve_cli_accepts_the_arch(name, monkeypatch):
    """``--arch`` resolves to the registered config and passes the launcher's
    checks; the run is stopped where it would pick the device and allocate
    the full-width model.  An unknown arch raises KeyError first."""
    seen = {}

    def stop(device):
        seen["device"] = device
        raise SystemExit(0)

    monkeypatch.setattr(serve_cli, "resolve_device", stop)
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", name, "--cache", "paged", "--requests", "8"])
    assert seen == {"device": "cuda"}
    with pytest.raises(KeyError, match="unknown arch"):
        serve_cli.main(["--arch", name + "-x", "--cache", "paged"])
