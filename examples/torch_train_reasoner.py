"""Train the synthetic reasoning model on the PyTorch port.

The reference's recipe (``examples/common.py`` ``get_reasoner``):
``tiny-reasoner`` from seed 0, ``ChainTask()`` batches of 64 from seed 0,
AdamW at lr 1e-3 with 50 warmup steps and a cosine over 1200 steps, no
recomputation.  The parameters go to ``artifacts/tiny_reasoner_torch.ckpt``
in the reference's checkpoint format, so the JAX package's examples load
it as well as the port's launcher (``repro_torch.launch.serve --arch
tiny-reasoner --ckpt artifacts/tiny_reasoner_torch.ckpt``).

Run:  PYTHONPATH=src python examples/torch_train_reasoner.py        # GPU
      PYTHONPATH=src python examples/torch_train_reasoner.py --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import device_put_batch, train_batches
from repro_torch.data.synthetic import ChainTask
from repro_torch.device import resolve_device
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "artifacts", "tiny_reasoner_torch.ckpt")


def train(steps: int = 1200, device="cuda", *, batch: int = 64, log=print):
    """Train ``tiny-reasoner`` by the recipe (``batch`` rows a step).
    Returns (cfg, params, history): history is [(step, loss, accuracy)] at
    every 200th step and the last, the only steps whose metrics are read
    (each read waits for the device)."""
    dev = resolve_device(device)
    cfg = get_config("tiny-reasoner")
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=50,
                                       total_steps=steps), remat=False)
    step_fn = make_train_step(cfg, tcfg)
    history = []
    t0 = time.time()
    for i, batch in zip(range(steps), train_batches(ChainTask(), batch, seed=0)):
        state, metrics = step_fn(state, device_put_batch(batch, dev))
        if i % 200 == 0 or i == steps - 1:
            history.append((i, float(metrics["loss"]), float(metrics["accuracy"])))
            log(f"  step {i}: loss={history[-1][1]:.3f} "
                f"acc={history[-1][2]:.3f} ({time.time() - t0:.0f}s)")
    return cfg, state.params, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    ap.add_argument("--out", default=CKPT)
    args = ap.parse_args()
    if os.path.exists(args.out):
        print(f"checkpoint already at {args.out}; delete it to retrain")
        return
    print(f"training tiny-reasoner for {args.steps} steps on {args.device}...")
    cfg, params, _ = train(args.steps, args.device)
    save_checkpoint(args.out, params, cfg)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
