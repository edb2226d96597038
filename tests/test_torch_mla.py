"""The port's multi-head latent attention (DeepSeek-V2's MLA) against the JAX
reference on the CPU (float32; ``deepseek-v2-236b``.reduced() on both
sides, the parameters carried by ``params.from_jax``).

* The config: the reduced variant and the full one equal the reference's.
* ``mla_absorbed_attend`` (the cached form) equals ``mla_self_attention``
  (the expanded, training form) within 2e-4, the reference's own bar; each
  equals the reference's function within 1e-5.
* ``prefill``, ``decode_step`` and ``probe_entropy`` against the JAX
  ``Model`` within 1e-5, ring and paged; a prefill of the whole prompt
  equals a short prefill and then steps within 2e-2 of max |logits|
  (``tests/test_parity.py``'s bar).
* A probe that wraps past the ring's capacity onto slot 0 (and its paged
  twin) leaves every latent ``c`` and rope key ``kr`` as they were.
* The paged self-EAT serve against the JAX engine at delta 0 and 1e9:
  tokens, exits and answers exactly, EAT traces within 1e-5; inside the
  port, paged == ring and same-weights proxy == self-EAT bitwise,
  overlapped == sync bitwise but for the last bits of the EAT traces of
  requests admitted behind a running chunk (rtol 1e-6).
* ``train_loss`` and every gradient leaf against ``jax.value_and_grad``
  within 1e-5; a port checkpoint is the reference's file byte for byte;
  ``param_specs`` gives the reference's leaf paths, shapes and dtypes
  (reduced, and at full width cut to 3 layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import Model as JModel
from repro.models import attention as jatt
from repro.serving.cache import alloc_cache as jalloc
from repro.training.checkpoint import save_checkpoint as jsave
from repro.utils.treeutil import tree_flatten_with_paths as jflatten
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import device_put_batch
from repro_torch.data.synthetic import ChainTask
from repro_torch.models import attention as att
from repro_torch.models.model import Model, train_loss
from repro_torch.params import from_jax, param_specs, to_jax
from repro_torch.serving.cache import alloc_cache, alloc_paged_cache
from repro_torch.serving.proxy import ProxyConfig
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.train_loop import trainable
from repro_torch.utils.treeutil import tree_flatten_with_paths, tree_leaves

from _torch_threads import _one_thread  # noqa: F401
from test_torch_moe import _assert_bit_equal, _jax_serve, _np, _rebuild, _serve

NAME = "deepseek-v2-236b"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_config_matches_reference():
    for ref, mine in ((jget(NAME), get_config(NAME)),
                      (jget(NAME).reduced(), get_config(NAME).reduced())):
        assert mine.mla is not None and ref.mla.__dict__ == mine.mla.__dict__
        assert ref.moe.__dict__ == mine.moe.__dict__
        for f in ("name", "arch_type", "source", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "head_dim", "d_ff", "vocab", "activation",
                  "rope_theta", "norm_eps", "tie_embeddings", "dtype"):
            assert getattr(mine, f) == getattr(ref, f), f
        assert mine.moe_layer_mask() == ref.moe_layer_mask()
    red = get_config(NAME).reduced().mla
    assert (red.kv_lora_rank, red.q_lora_rank, red.qk_nope_head_dim,
            red.qk_rope_head_dim, red.v_head_dim) == (32, 48, 32, 16, 32)
    assert att.attn_scale(get_config(NAME)) == jatt.attn_scale(jget(NAME)) \
        == 1.0 / np.sqrt(128 + 64)


@pytest.fixture(scope="module")
def layer():
    """One reduced MLA layer's weights (the reference's init) and a short
    input, in both packages."""
    jcfg, cfg = jget(NAME).reduced(), get_config(NAME).reduced()
    jp = jatt.mla_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    B, S = 2, 7
    jx = jax.random.normal(jax.random.PRNGKey(1), (B, S, jcfg.d_model)) * 0.5
    jpos = jnp.broadcast_to(jnp.arange(S), (B, S)).astype(jnp.int32)
    p = {k: _t(v) for k, v in jp.items()}
    return jcfg, cfg, jp, p, jx, jpos, _t(jx), _t(jpos)


def test_absorbed_equals_expanded_and_the_reference(layer):
    jcfg, cfg, jp, p, jx, jpos, x, pos = layer
    y_exp, (c, kr) = att.mla_self_attention(p, x, pos, pos, cfg)
    q_nope, q_rope = att.mla_q(p, x, pos, cfg)
    y_abs = att.mla_absorbed_attend(p, q_nope, q_rope, pos, cfg, c, kr, pos)
    np.testing.assert_allclose(y_exp.numpy(), y_abs.numpy(), atol=2e-4, rtol=2e-4)
    jy_exp, (jc, jkr) = jatt.mla_self_attention(jp, jx, jpos, jpos, jcfg,
                                                attn_impl="xla")
    jq_nope, jq_rope = jatt.mla_q(jp, jx, jpos, jcfg)
    jy_abs = jatt.mla_absorbed_attend(jp, jq_nope, jq_rope, jpos, jcfg, jc, jkr,
                                      jpos, attn_impl="xla")
    for mine, ref in ((c, jc), (kr, jkr), (q_nope, jq_nope), (q_rope, jq_rope),
                      (y_exp, jy_exp), (y_abs, jy_abs)):
        assert tuple(mine.shape) == ref.shape
        np.testing.assert_allclose(_np(mine), _np(ref), rtol=1e-5, atol=1e-5)
    assert tuple(c.shape) == (2, 7, 32) and tuple(kr.shape) == (2, 7, 16)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jget(NAME).reduced(), get_config(NAME).reduced()
    jmodel = JModel(jcfg, attn_impl="xla")
    jparams = jmodel.init(jax.random.PRNGKey(11))
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, cfg, params


def test_param_layout_round_trips(pair):
    _, jparams, cfg, params = pair
    attn = params["layers"][0]["attn"]
    assert sorted(attn) == ["kv_norm", "q_norm", "w_dkv", "w_dq", "w_kr", "w_uk",
                            "w_uq", "w_uv", "wo"]
    assert "ffn" in params["layers"][0] and "moe" in params["layers"][1]
    back = dict(tree_flatten_with_paths(to_jax(params, cfg)))
    ref = dict(jflatten(jparams))
    assert sorted(back) == sorted(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(back[path].numpy(), np.asarray(leaf), path)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full-width"])
def test_param_specs_are_the_references(reduced):
    """Paths, shapes and dtypes of every leaf, for the reduced config and at
    full width with the depth cut to 3 layers, as the card's smoke cuts it
    (abstract on both sides: nothing allocated)."""
    jcfg, cfg = jget(NAME), get_config(NAME)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    else:
        jcfg, cfg = (dataclasses.replace(c, n_layers=3) for c in (jcfg, cfg))
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.PRNGKey(0))
    ref = {path: (tuple(s.shape), s.dtype.name) for path, s in jflatten(shapes)}
    assert param_specs(cfg) == ref


def _inputs():
    B, S = 2, 12
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 512, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, :4], pos[1, 4:], toks[1, :4] = -1, np.arange(S - 4), 0
    return toks, pos


def _port_cache(cfg, kind, B, C):
    if kind == "ring":
        return alloc_cache(cfg, B, C, device="cpu")
    cache = alloc_paged_cache(cfg, B, C, 4, 1 + B * C // 4, device="cpu")
    # every row's blocks mapped to pages of its own, in a shuffled order
    pages = np.random.default_rng(1).permutation(B * C // 4) + 1
    cache["page_table"].copy_(torch.from_numpy(pages.reshape(B, C // 4).astype(np.int32)))
    return cache


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_prefill_decode_probe_match_jax(pair, kind):
    jm, params, cfg, tparams = pair
    tm = Model(cfg, tparams)
    toks, pos = _inputs()
    B = toks.shape[0]
    jcache, tcache = jalloc(jm.cfg, B, 32), _port_cache(cfg, kind, B, 32)
    assert sorted(tcache["layers"][0]) == ["c", "kr"]
    jh, jcache = jm.prefill(params, jnp.asarray(toks), jnp.asarray(pos),
                            jnp.asarray(pos), jcache)
    th = tm.prefill(torch.from_numpy(toks).long(), torch.from_numpy(pos),
                    torch.from_numpy(pos), tcache)
    np.testing.assert_allclose(_np(th), _np(jh), rtol=1e-5, atol=1e-5)
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


def test_prefill_equals_stepwise_decode(pair):
    _, _, cfg, params = pair
    model = Model(cfg, params)
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    ref = model.logits(model.prefill(toks, pos, pos, alloc_cache(cfg, B, 24, device="cpu")))
    cache = alloc_cache(cfg, B, 24, device="cpu")
    outs = [model.logits(model.prefill(toks[:, :5], pos[:, :5], pos[:, :5], cache))[:, -1]]
    for t in range(5, S):
        outs.append(model.decode_step(toks[:, t:t + 1], pos[:, t:t + 1],
                                      pos[:, t:t + 1], cache)[:, -1])
    stepped = torch.stack(outs, 1)
    scale = float(ref[:, 4:].abs().max()) + 1e-9
    assert float((stepped - ref[:, 4:]).abs().max()) / scale < 2e-2


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_wrapping_probe_keeps_the_latents(pair, kind):
    """A ring of 16 slots holding 15 tokens: a 2-token probe writes slots 15
    and 0 (the prompt's first token).  Afterwards every ``c`` and ``kr`` is
    as it was, and the next decode step equals one on a cache never
    probed, bitwise."""
    _, _, cfg, params = pair
    model = Model(cfg, params)
    B, S, C = 2, 15, 16
    toks = torch.from_numpy(np.random.default_rng(2).integers(4, cfg.vocab, (B, S)))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    caches = [_port_cache(cfg, kind, B, C) for _ in range(2)]
    for cache in caches:
        model.prefill(toks, pos, pos, cache)
    probed = caches[0]
    before = [{n: t.clone() for n, t in e.items()} for e in probed["layers"]]
    pp = torch.tensor([[15, 16]], dtype=torch.int32).expand(B, 2).contiguous()
    eat = model.probe_entropy(torch.tensor([[1, 6]]).expand(B, 2), pp, pp, probed)
    assert bool(torch.isfinite(eat).all())
    for e, old in zip(probed["layers"], before):
        for n, t in old.items():
            assert torch.equal(e[n], t), n
    assert int(probed["cur"]) == S and int((probed["pos"] >= 0).sum()) == B * S
    nxt = torch.tensor([[3], [5]])
    p1 = torch.full((B, 1), S, dtype=torch.int32)
    outs = [model.decode_step(nxt, p1, p1, cache) for cache in caches]
    assert torch.equal(outs[0], outs[1])


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
    else:
        assert {o["exit_reason"] for o in out} == {"budget"}


@pytest.fixture(scope="module")
def batch():
    return ChainTask().serve_batch(np.random.default_rng(7), 6)


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
    """As ``test_torch_moe.py``'s: the first cohort's EAT traces bitwise,
    those of requests admitted behind a running chunk to rtol 1e-6."""
    model, paged = paged_serve
    out = _serve(model, batch, 0.0, overlap=True)
    assert len(out) == len(paged) == 6
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
    for leaf in ("w_uk", "w_uv", "w_kr", "kv_norm"):
        assert float(g[f"stack/moe_layers/attn/{leaf}"].abs().max()) > 0, leaf


def test_checkpoint_is_the_references_bytes(tmp_path):
    jcfg, cfg = jget(NAME).reduced(), get_config(NAME).reduced()
    jparams = JModel(jcfg, attn_impl="xla").init(jax.random.PRNGKey(3))
    jsave(str(tmp_path / "ref.ckpt"), jparams)
    save_checkpoint(str(tmp_path / "port.ckpt"),
                    from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu"),
                    cfg)
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "ref.ckpt").read_bytes()
