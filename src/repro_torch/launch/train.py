"""Training launcher on the port (the reference's ``repro/launch/train.py``
on one device):

  python -m repro_torch.launch.train --arch qwen3-1.7b --steps 100   # GPU
  python -m repro_torch.launch.train --device cpu --reduced --arch qwen3-1.7b \\
      --steps 20                                                  # CPU
  python -m repro_torch.launch.train --device cpu --arch tiny --steps 3 \\
      --ckpt /tmp/tiny.ckpt                         # a checkpoint to serve

The reference's ``--local`` is ``--device cpu --reduced`` here, and as there
the layers are recomputed in the backward pass (``remat``) except on the
CPU.  Training runs on ``ChainTask`` batches (sequences of ``--seq``
tokens, 96 by default), AdamW with a cosine schedule to ``--steps``, and
prints every 20 steps in the reference's format.  ``--ckpt`` writes the
parameters in the reference's format (``training/checkpoint.py``), which
``repro_torch.launch.serve --ckpt`` and the JAX package both load.
``--multipod`` (the reference's production mesh) waits for the port's
multi-GPU layer.  ``--device cuda`` (the default) without a GPU raises.
An encoder-decoder (``seamless-m4t-large-v2``) is refused by name: the
``ChainTask`` batches carry no encoder frames, and the reference's launcher
fails there too.  ``models.model.train_loss`` trains it on a batch with
``frames``.
"""
from __future__ import annotations

import argparse
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if cfg.arch_type == "encdec":
        raise ValueError(
            f"the launcher's ChainTask batches carry no encoder frames: the "
            f"encoder-decoder {cfg.name} trains through train_loss(params, cfg, "
            f"batch) with batch['frames'] (B, T, d_model)")
    dev = resolve_device(args.device)
    if args.reduced:
        cfg = cfg.reduced()
    task = ChainTask(seq_len=args.seq or 96)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    tcfg = TrainConfig(opt=AdamWConfig(lr=args.lr, total_steps=args.steps),
                       remat=dev.type != "cpu")
    step_fn = make_train_step(cfg, tcfg)
    it = train_batches(task, args.batch, seed=0)
    next(it)                    # the reference's first batch only traces the step

    t0 = time.time()
    for i, batch in zip(range(args.steps), it):
        state, metrics = step_fn(state, device_put_batch(batch, dev))
        if i % 20 == 0:
            print(f"step {i}: loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, state.params, cfg)
        print(f"saved {args.ckpt}")


if __name__ == "__main__":
    main()
