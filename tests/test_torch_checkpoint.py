"""Checkpoints in the reference's format, between the port and the JAX
package, on the CPU.

* The port's msgpack subset writes what ``msgpack.packb(...,
  use_bin_type=True)`` writes, byte for byte, and reads it back; other
  types raise.
* ``reduced()`` gives the reference's reduced config.
* For the same parameters the port's file and the reference's file are
  byte-identical (float32 ``tiny``, bfloat16 reduced ``qwen3-1.7b``, and
  ``tiny-ssm``), and each loads into the other package bitwise; a file of
  another config or dtype is refused.
* A ``tiny-reasoner`` trained 20 steps by the port, loaded into the JAX
  ``Model``, gives the port's ``train_loss`` within 1e-5; a reference-written
  checkpoint served by the port's greedy engine gives the JAX engine's
  tokens, exits and answers exactly.
* The launchers as subprocesses: ``train --device cpu --ckpt`` writes a
  file that ``serve --device cpu --ckpt`` serves; without a GPU,
  ``train`` without ``--device cpu`` exits nonzero.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
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
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReasoningEngine as JEngine
from repro.serving.sampler import SamplerConfig as JSampler
from repro.training.checkpoint import load_checkpoint as jload
from repro.training.checkpoint import save_checkpoint as jsave
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.data.pipeline import device_put_batch
from repro_torch.models.model import Model, train_loss
from repro_torch.params import from_jax, to_jax
from repro_torch.serving.cache import CacheConfig
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.utils import msgpack as mp
from repro_torch.utils.treeutil import tree_flatten_with_paths

from _torch_threads import _one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "examples"))


def _configs(name):
    if name == "qwen3-reduced-bf16":
        return tuple(dataclasses.replace(get("qwen3-1.7b").reduced(), dtype="bfloat16")
                     for get in (jget, get_config))
    return jget(name), get_config(name)


def _jparams(name, seed=0):
    jcfg, cfg = _configs(name)
    return jcfg, JModel(jcfg, attn_impl="xla").init(jax.random.PRNGKey(seed)), cfg


def _port(jparams, cfg):
    return from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")


def _like(jcfg):
    m = JModel(jcfg, attn_impl="xla")
    return jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0)))


def _assert_same_port_trees(a, b):
    fa, fb = tree_flatten_with_paths(a), tree_flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def _assert_same_jax_trees(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


PAYLOADS = [
    {},
    {"embed/embedding": {"dtype": "float32", "shape": [3, 4], "data": b"\x00" * 48}},
    {"a" * 31: [0, 1, 127], "b" * 32: [128, 255, 256, 65535, 65536, 2**32 - 1,
                                       2**32, 2**64 - 1]},
    {"bin8": b"x" * 255, "bin16": b"y" * 256, "bin32": b"z" * 65536,
     "str8": "s" * 255, "str16": "t" * 256, "shape": [], "wide": list(range(16)),
     "map16": {str(i): i for i in range(16)}},
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=range(len(PAYLOADS)))
def test_msgpack_subset_matches_the_package(payload):
    data = msgpack.packb(payload, use_bin_type=True)
    assert mp.packb(payload) == data
    assert mp.unpackb(data) == msgpack.unpackb(data, raw=False) == payload


@pytest.mark.parametrize("obj", [1.5, -1, None, True, b"\xc0"],
                         ids=["float", "negative", "nil", "bool", "nil-byte"])
def test_msgpack_subset_refuses_other_types(obj):
    if isinstance(obj, bytes):
        with pytest.raises(ValueError, match="unsupported"):
            mp.unpackb(obj)
        return
    with pytest.raises(TypeError):
        mp.packb({"k": obj})
    with pytest.raises(ValueError, match="unsupported"):
        mp.unpackb(msgpack.packb({"k": obj}))


@pytest.mark.parametrize("name", ["tiny", "qwen3-1.7b", "mamba2-2.7b",
                                  "eat-paper-8b"])
def test_reduced_matches_reference(name):
    mine, ref = get_config(name).reduced(), jget(name).reduced()
    for f in dataclasses.fields(mine):
        want = getattr(ref, f.name)
        got = getattr(mine, f.name)
        if f.name == "ssm" and want is not None:
            want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert got == want, f.name


@pytest.mark.parametrize("name", ["tiny", "qwen3-reduced-bf16", "tiny-ssm"])
def test_files_identical_and_interchangeable(name, tmp_path):
    jcfg, jparams, cfg = _jparams(name)
    params = _port(jparams, cfg)
    jsave(str(tmp_path / "ref.ckpt"), jparams)
    save_checkpoint(str(tmp_path / "port.ckpt"), params, cfg)
    ref = (tmp_path / "ref.ckpt").read_bytes()
    assert (tmp_path / "port.ckpt").read_bytes() == ref
    # the reference's file into the port, the port's into the reference
    _assert_same_port_trees(load_checkpoint(str(tmp_path / "ref.ckpt"), cfg, "cpu"),
                            params)
    _assert_same_jax_trees(jload(str(tmp_path / "port.ckpt"), _like(jcfg)), jparams)
    # and back again, unchanged
    jsave(str(tmp_path / "again.ckpt"),
          jload(str(tmp_path / "port.ckpt"), _like(jcfg)))
    assert (tmp_path / "again.ckpt").read_bytes() == ref


def test_to_jax_inverts_from_jax():
    jcfg, jparams, cfg = _jparams("qwen3-reduced-bf16")
    tree = to_jax(_port(jparams, cfg), cfg)
    ref = dict(tree_flatten_with_paths(jax.tree_util.tree_map(np.asarray, jparams)))
    got = dict(tree_flatten_with_paths(tree))
    assert sorted(got) == sorted(ref)
    for path, a in ref.items():
        assert got[path].dtype == torch.bfloat16 and tuple(got[path].shape) == a.shape
        np.testing.assert_array_equal(got[path].float().numpy(), a.astype(np.float32))


def test_loader_refuses_another_config(tmp_path):
    _, jparams, cfg = _jparams("tiny")
    save_checkpoint(str(tmp_path / "t.ckpt"), _port(jparams, cfg), cfg)
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint(str(tmp_path / "t.ckpt"), get_config("tiny-ssm"), "cpu")
    with pytest.raises(ValueError, match="needs bfloat16"):
        load_checkpoint(str(tmp_path / "t.ckpt"),
                        dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    with pytest.raises(ValueError, match="needs"):
        load_checkpoint(str(tmp_path / "t.ckpt"),
                        dataclasses.replace(cfg, d_ff=64), "cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """tiny-reasoner after 20 steps of the port's recipe (batches of 16),
    saved by the port."""
    from torch_train_reasoner import train

    cfg, params, history = train(20, "cpu", batch=16, log=lambda _: None)
    path = str(tmp_path_factory.mktemp("ckpt") / "reasoner.ckpt")
    save_checkpoint(path, params, cfg)
    return cfg, params, history, path


def test_trained_checkpoint_gives_the_port_loss_in_jax(trained):
    cfg, params, history, path = trained
    assert history[-1][1] < history[0][1]
    jcfg = jget("tiny-reasoner")
    jparams = jload(path, _like(jcfg))
    batch = ChainTask().batch(np.random.default_rng(11), 8)
    jloss, jm = JModel(jcfg, attn_impl="xla").train_loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)
    with torch.no_grad():
        loss, m = train_loss(params, cfg, device_put_batch(batch, "cpu"), remat=False)
    for k in ("loss", "ce", "z_loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_port_serves_a_reference_checkpoint_as_jax_does(trained, tmp_path):
    """The trained weights re-written by the reference's writer, then
    served greedy by both engines (paged, EAT every 4 tokens, answers)."""
    cfg, _, _, path = trained
    jcfg = jget("tiny-reasoner")
    jparams = jload(path, _like(jcfg))
    jsave(str(tmp_path / "ref.ckpt"), jparams)
    model = Model(cfg, load_checkpoint(str(tmp_path / "ref.ckpt"), cfg, "cpu"))
    batch = ChainTask().serve_batch(np.random.default_rng(3), 6)
    kw = dict(max_reasoning_tokens=24, capacity=256, pad_id=Tokens.PAD,
              end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
              eos_id=Tokens.EOS, chunk_len=8)
    mon = dict(schedule="every_n", every_n=4, min_evals=1)
    ref = JEngine(
        JModel(jcfg, attn_impl="xla", paged_attn_impl="xla"), jparams,
        JEngineConfig(**kw, sampler=JSampler(greedy=True),
                      cache=JCache(kind="paged", page_size=16, attn_impl="xla")),
        JMonitor(stopper=JStopper(alpha=0.2, delta=0.2),
                 probe=jprobe(Tokens.END_THINK, (Tokens.ANS,)), **mon),
    ).serve(batch["prompts"], batch["prompt_len"], jax.random.PRNGKey(0),
            batch_size=4, max_tokens=24, answer_len=4)
    out = ReasoningEngine(
        model, EngineConfig(**kw, sampler=SamplerConfig(greedy=True),
                            cache=CacheConfig(kind="paged", page_size=16,
                                              attn_impl="auto")),
        ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=0.2),
                         probe=make_probe(Tokens.END_THINK, (Tokens.ANS,)), **mon),
    ).serve(batch["prompts"], batch["prompt_len"], None, batch_size=4,
            max_tokens=24, answer_len=4)
    assert len(out) == len(ref) == 6
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o["reasoning_tokens"],
                                      np.asarray(r["reasoning_tokens"]))
        assert (o["n_reasoning"], o["exit_reason"], o["ended_think"]) == \
               (r["n_reasoning"], r["exit_reason"], r["ended_think"])
        np.testing.assert_array_equal(o["answer_tokens"], np.asarray(r["answer_tokens"]))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def _run(*args):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, env=_env(), timeout=300)


def test_train_and_serve_clis_on_cpu(tmp_path):
    ckpt = str(tmp_path / "tiny.ckpt")
    r = _run("repro_torch.launch.train", "--device", "cpu", "--arch", "tiny",
             "--steps", "3", "--batch", "4", "--ckpt", ckpt)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "step 0: loss=" in r.stdout and f"saved {ckpt}" in r.stdout
    assert os.path.getsize(ckpt) > 0
    r = _run("repro_torch.launch.serve", "--device", "cpu", "--arch", "tiny",
             "--ckpt", ckpt, "--requests", "4", "--batch", "2", "--budget", "8",
             "--cache", "paged", "--attn-impl", "auto")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "served 4 requests" in r.stdout and "random weights" not in r.stdout


def test_train_cli_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    r = _run("repro_torch.launch.train", "--arch", "tiny", "--steps", "1")
    assert r.returncode != 0 and "device='cpu'" in r.stderr
