"""The port's serving slice end to end on the CPU.

* Against JAX: the seeded workload of tests/test_paged_attention.py (tiny,
  paged cache, page-native read, greedy, probe every 4 tokens, answers of
  4 tokens) served by both engines from the same params gives identical
  reasoning tokens, exit steps and reasons, forced answers and EAT
  evaluation counts; the traced EMA variance agrees within float32
  tolerance (atol 1e-5, rtol 1e-4: two float32 forwards feed each value).
* Inside the port: paged == ring bitwise (tokens, answers, EAT traces),
  also with admission holes in a tight page pool.
* The package (the trainer and the example that trains too) imports none
  of jax, repro, msgpack and ml_dtypes; the CLI runs on the CPU.
"""
import os
import subprocess
import sys

import jax
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
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.models.model import Model
from repro_torch.params import from_jax
from repro_torch.serving.cache import CacheConfig
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.sampler import SamplerConfig

from _torch_threads import _one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def workload():
    jcfg = jget("tiny")
    jmodel = JModel(jcfg, attn_impl="xla")
    params = jmodel.init(jax.random.PRNGKey(11))
    cfg = get_config("tiny")
    model = Model(cfg, from_jax(jax.tree_util.tree_map(np.asarray, params),
                                cfg, "cpu"))
    batch = ChainTask().serve_batch(np.random.default_rng(7), 6)
    return jmodel, params, model, batch


def _jax_serve(jmodel, params, batch, delta):
    ecfg = JEngineConfig(
        max_reasoning_tokens=24, capacity=256, pad_id=Tokens.PAD,
        end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
        eos_id=Tokens.EOS, chunk_len=8, sampler=JSampler(greedy=True),
        cache=JCache(kind="paged", page_size=16, attn_impl="xla"))
    mon = JMonitor(stopper=JStopper(alpha=0.2, delta=delta),
                   probe=jprobe(Tokens.END_THINK, (Tokens.ANS,)),
                   schedule="every_n", every_n=4, min_evals=1)
    return JEngine(jmodel, params, ecfg, mon).serve(
        batch["prompts"], batch["prompt_len"], jax.random.PRNGKey(0),
        batch_size=4, max_tokens=24, answer_len=4, record_trace=True)


def _serve(model, batch, delta, *, kind="paged", attn="auto", capacity=256,
           num_pages=0, batch_size=4, answer_len=4):
    ecfg = EngineConfig(
        max_reasoning_tokens=24, capacity=capacity, pad_id=Tokens.PAD,
        end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
        eos_id=Tokens.EOS, chunk_len=8, sampler=SamplerConfig(greedy=True),
        cache=CacheConfig(kind=kind, page_size=16, num_pages=num_pages,
                          attn_impl=attn))
    mon = ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=delta),
                           probe=make_probe(Tokens.END_THINK, (Tokens.ANS,)),
                           schedule="every_n", every_n=4, min_evals=1)
    return ReasoningEngine(model, ecfg, mon).serve(
        batch["prompts"], batch["prompt_len"], None, batch_size=batch_size,
        max_tokens=24, answer_len=answer_len, record_trace=True)


def _assert_bit_equal(ref, out):
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        assert (r["n_reasoning"], r["exit_reason"], r["ended_think"]) == \
               (o["n_reasoning"], o["exit_reason"], o["ended_think"])
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
        if "answer_tokens" in r:
            np.testing.assert_array_equal(r["answer_tokens"], o["answer_tokens"])
        assert r["eat_trace"] == o["eat_trace"]


@pytest.mark.parametrize("delta", [1e9, 0.2, 0.0])
def test_paged_serve_matches_jax(workload, delta):
    jmodel, params, model, batch = workload
    ref = _jax_serve(jmodel, params, batch, delta)
    out = _serve(model, batch, delta)
    assert len(out) == len(ref) == 6
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o["reasoning_tokens"],
                                      np.asarray(r["reasoning_tokens"]))
        assert o["n_reasoning"] == r["n_reasoning"]
        assert o["exit_reason"] == r["exit_reason"]
        assert o["ended_think"] == r["ended_think"]
        np.testing.assert_array_equal(o["answer_tokens"],
                                      np.asarray(r["answer_tokens"]))
        assert [e[:2] for e in o["eat_trace"]] == [e[:2] for e in r["eat_trace"]]
        np.testing.assert_allclose([e[2] for e in o["eat_trace"]],
                                   [e[2] for e in r["eat_trace"]],
                                   atol=1e-5, rtol=1e-4)
    if delta == 1e9:
        assert {o["exit_reason"] for o in out} == {"eat"}


@pytest.mark.parametrize("delta", [1e9, 0.0])
def test_port_paged_serve_identical_to_ring(workload, delta):
    _, _, model, batch = workload
    _assert_bit_equal(_serve(model, batch, delta, kind="ring"),
                      _serve(model, batch, delta, kind="paged"))


def test_port_paged_serve_with_admission_holes(workload):
    """14 requests through a 24-data-page pool: admissions map prompt
    blocks + the current decode block, leaving interior holes the
    page-native read skips — still bitwise the ring's streams."""
    _, _, model, _ = workload
    b = ChainTask().serve_batch(np.random.default_rng(9), 14)
    ref = _serve(model, b, 0.0, kind="ring", capacity=400, answer_len=0)
    out = _serve(model, b, 0.0, kind="paged", capacity=400, num_pages=25,
                 answer_len=0)
    _assert_bit_equal(ref, out)


def test_port_serve_recycles_slots(workload):
    """6 requests through 4 slots: every result names the slot it ran in,
    and a slot freed by an exit serves a queued request."""
    _, _, model, batch = workload
    slots = [o["slot"] for o in _serve(model, batch, 1e9)]
    assert set(slots) <= set(range(4))
    assert len(set(slots)) < len(slots)


def test_port_gather_impl_matches_page_native(workload):
    """--attn-impl gather (the materialised logical view) serves the same
    greedy tokens and exits as the page-native read."""
    _, _, model, batch = workload
    ref = _serve(model, batch, 1e9, attn="auto")
    out = _serve(model, batch, 1e9, attn="gather")
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(r["reasoning_tokens"], o["reasoning_tokens"])
        assert r["exit_reason"] == o["exit_reason"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return env


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.kernels.ssd_scan.ops, repro_torch.models.ssm\n"
        "import repro_torch.configs.mamba2_2p7b\n"
        "import repro_torch.serving.proxy, repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.core.stopping, repro_torch.core.eat\n"
        "import repro_torch.serving.engine, repro_torch.serving.device_loop\n"
        "import repro_torch.serving.pipeline\n"
        "import repro_torch.launch.train, repro_torch.training.checkpoint\n"
        "import repro_torch.training.optimizer, repro_torch.training.train_loop\n"
        "import repro_torch.data.pipeline, repro_torch.utils.msgpack\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "sys.path.insert(0, sys.argv[1] + '/benchmarks')\n"
        "import torch_trace_harness\n"
        "sys.path.insert(0, sys.argv[1] + '/examples')\n"
        "import torch_train_reasoner\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'msgpack', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_serve_cli_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "tiny", "--requests", "6", "--batch", "2", "--cache", "paged",
         "--attn-impl", "auto", "--budget", "16"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "served 6 requests through 2 slots on cpu" in r.stdout, r.stdout


def test_serve_cli_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "tiny",
         "--requests", "2", "--batch", "2", "--budget", "4"],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode != 0 and "device='cpu'" in r.stderr
