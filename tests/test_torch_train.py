"""The port's training path against the JAX reference on the CPU.

* ``cross_entropy_loss`` and ``train_loss`` (loss, ce, z_loss, accuracy,
  tokens) on ``tiny`` and ``tiny-ssm`` in float32 within 1e-5, and every
  gradient leaf within rtol 1e-4, atol 1e-6 of ``jax.grad``; on
  ``qwen3-1.7b``.reduced() in bfloat16 on both sides, within 3e-2 (of the
  reference's value, and per gradient leaf of its largest magnitude).
* ``remat`` on and off give bitwise equal losses and gradients.
* ``cosine_schedule`` and one ``adamw_update`` (params, m, v, grad_norm,
  lr) within 1e-6 relative, float32 and bfloat16 parameters, with the clip
  active and not.  The global norm is held to 1e-6 of the exact norm of
  the same gradients, and to 1e-6 of the reference's in float32 (1e-5 in
  bfloat16: the reference's float32 sums of squares over bfloat16 leaves
  are ~3e-6 off the exact ones, the port's ~2e-8).  A leaf of params, m or
  v is held to 1e-6 of its largest magnitude (an m near 0, where ``b1 m +
  (1 - b1) g`` cancels, moves by more than 1e-6 of itself), plus, with the
  clip active, the two norms' relative difference, which each side's
  clip scale carries into every gradient; a bfloat16 parameter then may
  round one bf16 step the other way.  Unclipped, both sides scale by
  exactly 1, and the bfloat16 parameters are held to 1e-6 like the rest.
* Each kernel wrapper refuses an input that requires grad under grad mode
  (before it looks at the device), so it never returns a result that cuts
  the graph; with grad off it goes on to its checks.
* ``train_batches`` gives the reference's batches bitwise; 30 steps on
  ``tiny`` (the reference's ``tests/test_system.py`` run) track the
  reference's losses within 1e-4 over the first 10 steps and fall below
  0.7 x the first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.data.pipeline import train_batches as jtrain_batches
from repro.data.synthetic import ChainTask as JChainTask
from repro.models import Model as JModel
from repro.models.model import cross_entropy_loss as jcross_entropy
from repro.training import optimizer as jopt
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import init_train_state as jinit_train_state
from repro.training.train_loop import make_train_step as jmake_train_step
from repro.utils.treeutil import tree_flatten_with_paths as jflatten
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import device_put_batch, train_batches
from repro_torch.data.synthetic import ChainTask
from repro_torch.models.model import cross_entropy_loss, train_loss
from repro_torch.params import from_jax, to_jax
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (TrainConfig, TrainState,
                                             make_train_step, trainable)
from repro_torch.utils.treeutil import tree_flatten_with_paths, tree_leaves

from _torch_threads import _one_thread  # noqa: F401

METRICS = ("loss", "ce", "z_loss", "accuracy", "tokens")


def _configs(name):
    """(JAX config, port config): a registered config, or
    ``qwen3-1.7b``.reduced() in bfloat16."""
    if name == "qwen3-reduced-bf16":
        return tuple(dataclasses.replace(get("qwen3-1.7b").reduced(), dtype="bfloat16")
                     for get in (jget, get_config))
    return jget(name), get_config(name)


def _params(name, seed=0):
    jcfg, cfg = _configs(name)
    jparams = JModel(jcfg, attn_impl="xla").init(jax.random.PRNGKey(seed))
    return jcfg, jparams, cfg, from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                         cfg, "cpu")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rebuild(tree, it):
    """A tree of ``tree``'s structure whose leaves come from ``it`` in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(x, it) for x in tree]
    return next(it)


def _batch(seed=0, B=4, seq_len=40):
    return ChainTask(seq_len=seq_len).batch(np.random.default_rng(seed), B)


def _port_loss_and_grads(params, cfg, batch, remat):
    params = trainable(params)
    loss, metrics = train_loss(params, cfg, device_put_batch(batch, "cpu"),
                               remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return metrics, to_jax(_rebuild(params, iter(grads)), cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_loss_matches_jax(dtype):
    rng = np.random.default_rng(3)
    B, S, Vp, vocab = 3, 7, 256, 200
    logits = (rng.standard_normal((B, S, Vp)) * 3).astype(np.float32)
    targets = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32)
    jl = jnp.asarray(logits, dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
    jf = lambda x: jcross_entropy(x, jnp.asarray(targets), jnp.asarray(mask), vocab)  # noqa: E731
    (jloss, jm), jg = jax.value_and_grad(jf, has_aux=True)(jl)
    loss, m = cross_entropy_loss(tl, torch.from_numpy(targets),
                                 torch.from_numpy(mask), vocab)
    g, = torch.autograd.grad(loss, tl)
    jm["loss"], m["loss"] = jloss, loss
    for k in METRICS:
        np.testing.assert_allclose(_f32(m[k]), _f32(jm[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    tol = dict(rtol=1e-4, atol=1e-6) if dtype == "float32" else dict(rtol=3e-2, atol=1e-4)
    np.testing.assert_allclose(_f32(g), _f32(jg), **tol)


@pytest.mark.parametrize("name", ["tiny", "tiny-ssm", "qwen3-reduced-bf16"])
def test_train_loss_and_grads_match_jax(name):
    jcfg, jparams, cfg, params = _params(name)
    batch = _batch()
    jmodel = JModel(jcfg, attn_impl="xla")
    jf = lambda p: jmodel.train_loss(  # noqa: E731
        p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)
    (_, jm), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jparams)
    m, g = _port_loss_and_grads(params, cfg, batch, remat=True)
    bf16 = cfg.dtype == "bfloat16"
    for k in METRICS:
        np.testing.assert_allclose(_f32(m[k]), _f32(jm[k]),
                                   rtol=3e-2 if bf16 else 1e-5,
                                   atol=0 if bf16 else 1e-5, err_msg=k)
    jg, g = dict(jflatten(jg)), dict(tree_flatten_with_paths(g))
    assert sorted(jg) == sorted(g)
    for path, ref in jg.items():
        a, b = _f32(g[path]), _f32(ref)
        assert a.shape == b.shape, path
        if bf16:
            assert np.abs(a - b).max() <= 3e-2 * np.abs(b).max(), path
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("name", ["tiny", "tiny-ssm"])
def test_remat_is_bitwise(name):
    _, _, cfg, params = _params(name)
    batch = _batch(seed=1)
    m0, g0 = _port_loss_and_grads(params, cfg, batch, remat=False)
    m1, g1 = _port_loss_and_grads(params, cfg, batch, remat=True)
    for k in METRICS:
        assert torch.equal(m0[k], m1[k]), k
    for (p, a), (_, b) in zip(tree_flatten_with_paths(g0), tree_flatten_with_paths(g1)):
        assert torch.equal(a, b), p


def test_cosine_schedule_matches_jax():
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=50, total_steps=1200)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=50, total_steps=1200)
    for step in (0, 1, 50, 625, 1199, 1200, 1300):
        got = opt.cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = jopt.cosine_schedule(jcfg, jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, err_msg=step)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("name", ["tiny", "qwen3-reduced-bf16"])
def test_adamw_update_matches_jax(name, grad_scale):
    jcfg, jparams, cfg, params = _params(name)
    rng = np.random.default_rng(5)

    def rand_like(tree, dtype=None, positive=False):
        def f(x):
            a = rng.standard_normal(x.shape).astype(np.float32)
            a = np.abs(a) * 1e-4 if positive else a * grad_scale
            return jnp.asarray(a, dtype or x.dtype)
        return jax.tree_util.tree_map(f, tree)

    jgrads = rand_like(jparams)
    jm = rand_like(jparams, jnp.float32)
    jv = rand_like(jparams, jnp.float32, positive=True)
    c = dict(lr=1e-3, warmup_steps=5, total_steps=100)
    jstate = jopt.OptState(step=jnp.int32(7), m=jm, v=jv)
    jp2, js2, jmet = jax.jit(jopt.adamw_update, static_argnums=0)(
        jopt.AdamWConfig(**c), jgrads, jstate, jparams)

    host = lambda t: from_jax(jax.tree_util.tree_map(np.asarray, t), cfg, "cpu")  # noqa: E731
    state = opt.OptState(step=torch.tensor(7, dtype=torch.int32), m=host(jm), v=host(jv))
    p2, s2, met = opt.adamw_update(opt.AdamWConfig(**c), tree_leaves(host(jgrads)),
                                   state, params)
    assert int(s2.step) == int(js2.step) == 8 and s2.step.dtype == torch.int32
    np.testing.assert_allclose(_f32(met["lr"]), _f32(jmet["lr"]), rtol=1e-6)
    # the norm: 1e-6 of the exact sum of the same squares, and of the
    # reference's in float32; the reference's sum over bfloat16 leaves is
    # itself ~1.5e-6 off the exact one (its per-leaf sums lose ~3e-6)
    sq = sum(np.sum(_f32(g).astype(np.float64) ** 2)
             for g in jax.tree_util.tree_leaves(jgrads))
    gn, jgn = float(met["grad_norm"]), float(jmet["grad_norm"])
    assert abs(gn / np.sqrt(sq) - 1) <= 1e-6
    assert abs(gn / jgn - 1) <= (1e-6 if cfg.dtype == "float32" else 1e-5)
    assert (jgn > 1.0) == (grad_scale > 1)
    # clipped, each side scales its gradients by clip_norm / its own norm
    tol = 1e-6 + (abs(gn / jgn - 1) if jgn > 1.0 else 0.0)
    for got, want in ((p2, jp2), (s2.m, js2.m), (s2.v, js2.v)):
        got, want = dict(tree_flatten_with_paths(to_jax(got, cfg))), dict(jflatten(want))
        for path, ref in want.items():
            assert str(got[path].dtype).removeprefix("torch.") == str(ref.dtype), path
            a, b = _f32(got[path]), _f32(ref)
            if ref.dtype == jnp.bfloat16 and jgn > 1.0:
                # those float32 differences may round a bf16 parameter the
                # other way: one bf16 step, 2^-7 of the value at most
                assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(b)).all(), path
            else:
                assert np.abs(a - b).max() <= tol * np.abs(b).max(), path


@pytest.mark.parametrize("op", ["flash_attention", "paged_attention",
                                "entropy_probe", "ssd_scan", "decode_attention"])
def test_kernel_wrappers_refuse_autograd(op):
    import importlib

    fn = getattr(importlib.import_module(f"repro_torch.kernels.{op}.ops"), f"{op}_cuda")
    x = torch.zeros((1, 1, 1, 1), requires_grad=True)
    args = {"paged_attention": (x,) * 7, "entropy_probe": (x, x, 1),
            "ssd_scan": (x,) * 4}.get(op, (x,) * 5)
    kw = {"ssd_scan": dict(chunk=1), "entropy_probe": {}}.get(
        op, dict(scale=1.0, **({"logical": x, "num_blocks": 1}
                               if op == "paged_attention" else {})))
    with pytest.raises(RuntimeError, match=f"{op}: an input requires grad"):
        fn(*args, **kw)
    with torch.no_grad(), pytest.raises(ValueError):     # its own checks
        fn(*args, **kw)


def test_train_batches_match_reference():
    mine = train_batches(ChainTask(seq_len=64), 8, seed=3)
    ref = jtrain_batches(JChainTask(seq_len=64), 8, seed=3)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_thirty_steps_track_reference():
    """The reference's tests/test_system.py run, from the same weights and
    batches on both sides."""
    jcfg, jparams, cfg, params = _params("tiny")
    jmodel = JModel(jcfg, attn_impl="xla")
    jt = JTrainConfig(opt=jopt.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=100),
                      remat=False)
    jstate = jinit_train_state(jmodel, jax.random.PRNGKey(0))
    jstep = jax.jit(jmake_train_step(jmodel, jt), donate_argnums=0)
    tt = TrainConfig(opt=opt.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=100),
                     remat=False)
    state = TrainState(trainable(params), opt.adamw_init(params))
    step = make_train_step(cfg, tt)
    ref, mine = [], []
    for _, batch in zip(range(30), train_batches(ChainTask(seq_len=64), 16, seed=0)):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, met = step(state, device_put_batch(batch, "cpu"))
        ref.append(float(jmet["loss"]))
        mine.append(float(met["loss"]))
    np.testing.assert_allclose(mine[:10], ref[:10], atol=1e-4, rtol=0)
    assert mine[-1] < 0.7 * mine[0], mine[:3] + mine[-3:]
