"""Training the encoder-decoder (``seamless-m4t-large-v2``.reduced(): 2 + 2
layers, d 128, 32 frames, vocab 512) against the JAX reference on the
CPU, float32 (parameters carried by ``params.from_jax``; the JAX side on
``attn_impl="xla"``, as its trainer runs it).

* ``train_loss`` with ``frames`` (B, T, d): the metrics and every gradient
  leaf (the encoder's, the cross-attention's included) within 1e-5 of
  ``jax.value_and_grad`` of the reference's, with ``remat`` on and off;
  remat on and off are bitwise equal on the port.
* 3 AdamW steps of ``make_train_step`` against the reference's: the
  losses and the gradient norms of every step, and the moments after,
  within 1e-5.
* The training forward (``train_logits``) equals the serving prefill's
  logits on the same tokens and frames within 1e-5.
* ``frames`` are refused on a config that is not an encoder-decoder, and
  required on one; ``forward_train`` holds the same rule for ``enc_out``;
  the training launcher refuses the family by name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import Model as JModel
from repro.training import optimizer as jopt
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import TrainState as JTrainState
from repro.training.train_loop import make_train_step as jmake_train_step
from repro.utils.treeutil import tree_flatten_with_paths as jflatten
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import device_put_batch
from repro_torch.data.synthetic import ChainTask
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model, train_logits, train_loss
from repro_torch.params import from_jax, to_jax
from repro_torch.serving.cache import alloc_cache
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (TrainConfig, TrainState,
                                             make_train_step, trainable)
from repro_torch.utils.treeutil import tree_flatten_with_paths, tree_leaves

from _torch_threads import _one_thread  # noqa: F401

NAME = "seamless-m4t-large-v2"
METRICS = ("loss", "ce", "z_loss", "accuracy", "tokens")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jget(NAME).reduced(), get_config(NAME).reduced()
    jmodel = JModel(jcfg, attn_impl="xla")
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(5))
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, cfg, params


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _batch(cfg, seed=0, B=4):
    """ChainTask rows of 40 tokens and seeded stub frames (B, T, d) at
    0.1 N(0, 1), as the reference's smoke tests make them."""
    b = ChainTask(seq_len=40).batch(np.random.default_rng(seed), B)
    rng = np.random.default_rng(seed + 100)
    b["frames"] = (0.1 * rng.standard_normal((B, cfg.encoder_len, cfg.d_model))
                   ).astype(np.float32)
    return b


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(x, it) for x in tree]
    return next(it)


def _port_loss_and_grads(params, cfg, batch, remat):
    tp = trainable(params)
    loss, m = train_loss(tp, cfg, device_put_batch(batch, "cpu"), remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    return m, dict(tree_flatten_with_paths(to_jax(_rebuild(tp, iter(grads)), cfg)))


@pytest.fixture(scope="module")
def reference_grads(pair):
    jmodel, jparams, _, _ = pair
    batch = _batch(pair[2])
    jf = lambda p: jmodel.train_loss(  # noqa: E731
        p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)
    (_, jm), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jparams)
    return batch, jm, dict(jflatten(jg))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_loss_and_grads_with_frames_match_jax(pair, reference_grads, remat):
    _, _, cfg, params = pair
    batch, jm, jg = reference_grads
    m, g = _port_loss_and_grads(params, cfg, batch, remat)
    for k in METRICS:
        np.testing.assert_allclose(_np(m[k]), _np(jm[k]), err_msg=k, **TOL)
    assert sorted(jg) == sorted(g)
    for path, ref in jg.items():
        np.testing.assert_allclose(_np(g[path]), _np(ref), err_msg=path, **TOL)
    # the gradient reaches the encoder and the cross-attention
    for path in ("stack/enc_layers/attn/wq", "stack/enc_norm",
                 "stack/dec_layers/cross/wk", "stack/dec_layers/norm_c"):
        assert float(g[path].abs().max()) > 0, path


def test_remat_is_bitwise(pair):
    _, _, cfg, params = pair
    batch = _batch(cfg, seed=1)
    m0, g0 = _port_loss_and_grads(params, cfg, batch, remat=False)
    m1, g1 = _port_loss_and_grads(params, cfg, batch, remat=True)
    for k in METRICS:
        assert torch.equal(m0[k], m1[k]), k
    for path in g0:
        assert torch.equal(g0[path], g1[path]), path


def test_three_adamw_steps_match_jax(pair):
    jmodel, jparams, cfg, params = pair
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jmake_train_step(jmodel, JTrainConfig(opt=jopt.AdamWConfig(**ocfg),
                                                          remat=False)))
    jstate = JTrainState(jparams, jopt.adamw_init(jparams))
    step = make_train_step(cfg, TrainConfig(opt=opt.AdamWConfig(**ocfg), remat=True))
    state = TrainState(trainable(params), opt.adamw_init(params))
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, device_put_batch(batch, "cpu"))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(_np(m[k]), _np(jm[k]), err_msg=f"step {i} {k}",
                                       **TOL)
    # the moments hold the gradients themselves: m, and sqrt(v) (the RMS
    # gradient, on m's scale).  The parameters are not held element by
    # element: Adam divides each element's step by its own RMS gradient, so
    # an element whose gradient sits at float32 noise steps by up to lr
    # either way; the losses of steps 2 and 3 read the updated parameters.
    for name, f in (("m", _np), ("v", lambda t: np.sqrt(_np(t)))):
        mine = dict(tree_flatten_with_paths(to_jax(getattr(state.opt, name), cfg)))
        for path, ref in jflatten(getattr(jstate.opt, name)):
            np.testing.assert_allclose(f(mine[path]), f(ref), err_msg=f"{name} {path}",
                                       **TOL)
    assert int(state.opt.step) == int(jstate.opt.step) == 3


def test_training_forward_equals_serving_prefill(pair):
    """The same tokens and frames through ``train_logits`` and through a
    prefill into a ring cache: the logits of every position agree."""
    _, _, cfg, params = pair
    batch = _batch(cfg, seed=2, B=2)
    toks = torch.from_numpy(batch["tokens"]).long()
    pos = torch.from_numpy(batch["pos1d"][:, :toks.shape[1]].copy())
    frames = torch.from_numpy(batch["frames"])
    logits, _ = train_logits(params, cfg, toks, pos, pos, remat=False, frames=frames)
    model = Model(cfg, params)
    cache = alloc_cache(cfg, 2, 64, device="cpu")
    served = model.logits(model.prefill(toks, pos, pos, cache, frames=frames))
    valid = pos >= 0
    np.testing.assert_allclose(_np(logits[valid]), _np(served[valid]), **TOL)


def test_frames_go_with_an_encoder_decoder_only(pair):
    _, _, cfg, params = pair
    batch = device_put_batch(_batch(cfg), "cpu")
    no_frames = {k: v for k, v in batch.items() if k != "frames"}
    with pytest.raises(ValueError, match=f"{cfg.name} is an encoder-decoder"):
        train_loss(params, cfg, no_frames)
    tiny = get_config("tiny")
    with pytest.raises(ValueError, match="tiny is not an encoder-decoder"):
        train_loss({}, tiny, batch)
    x = torch.zeros((1, 4, cfg.d_model))
    p = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="enc_out"):
        tfm.forward_train(params["layers"], params["final_norm"], x, p, p, cfg)


def test_launcher_refuses_the_family_by_name():
    with pytest.raises(ValueError, match="seamless-m4t-large-v2"):
        train_cli.main(["--arch", NAME, "--device", "cpu", "--steps", "1"])
