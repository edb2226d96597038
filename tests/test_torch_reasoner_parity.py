"""A ``tiny-reasoner`` trained by the port, served greedily with EAT by the
JAX engine and by the port's engine from one checkpoint file, on the CPU.

The port trains by ``examples/torch_train_reasoner.py``'s recipe (seed 0,
AdamW at lr 1e-3, 50 warmup steps, a cosine to the last step), here for
``STEPS`` steps of ``BATCH`` rows so that the test stays short.  The
weights go through ``training/checkpoint.py`` into a file that both
packages load.  Both engines then serve the same 32 ChainTask prompts
through 8 slots of a paged cache, greedy, with the launcher's monitor (EAT
after each newline, delta 1e-3, alpha 0.2), budget 110 and answers of 4:
reasoning tokens, exits and answers must be equal exactly, and the EAT
traces within 1e-5.

Run as a script, it trains the whole recipe (1200 steps of 64) and prints
the same comparison with the exits of both packages::

    PYTHONPATH=src python tests/test_torch_reasoner_parity.py [--steps N]
"""
import argparse
import os
import sys
import tempfile

import jax
import numpy as np

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
from repro.serving.scheduler import SlotScheduler
from repro.training.checkpoint import load_checkpoint as jload
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.models.model import Model
from repro_torch.serving.cache import CacheConfig
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint

from _torch_threads import _one_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

STEPS, BATCH = 240, 8
N_REQ, SLOTS, BUDGET, DELTA, ALPHA = 32, 8, 110, 1e-3, 0.2


def train_and_save(path: str, steps: int, batch: int, log=lambda _: None):
    from torch_train_reasoner import train

    cfg, params, history = train(steps, "cpu", batch=batch, log=log)
    save_checkpoint(path, params, cfg)
    return history


def serve_both(path: str):
    """(the JAX engine's results, the port's) for the checkpoint at
    ``path``, served as the module docstring says."""
    jcfg = jget("tiny-reasoner")
    jmodel = JModel(jcfg, attn_impl="xla")
    like = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    jparams = jload(path, like)
    cfg = get_config("tiny-reasoner")
    model = Model(cfg, load_checkpoint(path, cfg, "cpu"))
    batch = ChainTask().serve_batch(np.random.default_rng(0), N_REQ)
    kw = dict(max_reasoning_tokens=BUDGET, pad_id=Tokens.PAD,
              end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
              eos_id=Tokens.EOS,
              capacity=SlotScheduler.required_capacity(
                  batch["prompts"].shape[1], N_REQ, SLOTS, BUDGET))
    ref = JEngine(
        jmodel, jparams,
        JEngineConfig(**kw, sampler=JSampler(greedy=True),
                      cache=JCache(kind="paged", page_size=16, attn_impl="xla")),
        JMonitor(stopper=JStopper(alpha=ALPHA, delta=DELTA),
                 probe=jprobe(Tokens.END_THINK, (Tokens.ANS,)),
                 newline_id=Tokens.NEWLINE),
    ).serve(batch["prompts"], batch["prompt_len"], jax.random.PRNGKey(0),
            batch_size=SLOTS, answer_len=4, record_trace=True)
    out = ReasoningEngine(
        model, EngineConfig(**kw, sampler=SamplerConfig(greedy=True),
                            cache=CacheConfig(kind="paged", page_size=16,
                                              attn_impl="auto")),
        ReasoningMonitor(stopper=EATStopper(alpha=ALPHA, delta=DELTA),
                         probe=make_probe(Tokens.END_THINK, (Tokens.ANS,)),
                         newline_id=Tokens.NEWLINE),
    ).serve(batch["prompts"], batch["prompt_len"], None, batch_size=SLOTS,
            answer_len=4, record_trace=True)
    return batch, ref, out


def assert_same(ref, out):
    assert len(out) == len(ref) == N_REQ
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


def summary(batch, results) -> str:
    ans = np.array([ChainTask.extract_answer(np.asarray(r["answer_tokens"])[None])[0]
                    for r in results])
    exits = {k: [r["exit_reason"] for r in results].count(k)
             for k in ("eat", "end_think", "budget")}
    return (f"exits {exits}, reasoning tokens "
            f"{sum(int(r['n_reasoning']) for r in results)}, EAT evaluations "
            f"{sum(len(r['eat_trace']) for r in results)}, forced-answer accuracy "
            f"{float((ans == batch['answers']).mean()):.3f}")


def test_trained_reasoner_serves_as_in_jax(tmp_path):
    path = str(tmp_path / "reasoner.ckpt")
    history = train_and_save(path, STEPS, BATCH)
    assert history[-1][1] < 0.5 * history[0][1]
    batch, ref, out = serve_both(path)
    assert_same(ref, out)
    assert sum(len(r["eat_trace"]) for r in out) > N_REQ     # EAT evaluated


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "reasoner.ckpt")
        history = train_and_save(path, args.steps, args.batch, log=print)
        batch, ref, out = serve_both(path)
    print(f"trained {args.steps} steps of {args.batch}: loss "
          f"{history[0][1]:.4f} -> {history[-1][1]:.4f}, token accuracy "
          f"{history[-1][2]:.3f}")
    print(f"JAX engine: {summary(batch, ref)}")
    print(f"port:       {summary(batch, out)}")
    assert_same(ref, out)
    print("tokens, exits and answers equal; EAT traces within 1e-5")


if __name__ == "__main__":
    main()
