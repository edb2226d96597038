"""Serving launcher: batched EAT-monitored reasoning serving on the port.

  python -m repro_torch.launch.serve --arch tiny --requests 10 --batch 4 \\
      --cache paged --attn-impl auto --budget 48            # on the GPU
  python -m repro_torch.launch.serve --device cpu --arch tiny --requests 6 \\
      --batch 2 --cache paged --attn-impl auto --budget 16   # on the CPU
  python -m repro_torch.launch.serve --arch mamba2-2.7b --cache ring \\
      --requests 8 --batch 4 --budget 64                     # Mamba2, GPU
  python -m repro_torch.launch.serve --device cpu --arch tiny --requests 4 \\
      --batch 2 --monitor proxy --proxy-config tiny-proxy     # black-box EAT
  python -m repro_torch.launch.serve --arch tiny-reasoner --requests 32 \\
      --batch 8 --ckpt artifacts/tiny_reasoner_torch.ckpt    # trained weights
  python -m repro_torch.launch.serve --arch tiny --requests 10 --batch 4 \\
      --cache paged --attn-impl auto --overlap on            # overlapped loop

``--ckpt`` loads the generator's weights from a checkpoint in the
reference's format (``repro_torch.launch.train --ckpt``,
``examples/torch_train_reasoner.py`` or the JAX package's trainer); without
it the weights are random from a fixed seed (a warning says so), so verify
mechanics — token counts, exits, slot recycling — not accuracy.
``--attn-impl``: ``gather`` materialises the paged cache's
logical view; ``auto``/``cuda``/``plain`` read K/V off the page pools
(``auto`` = the CUDA kernels on the GPU, the plain versions on the CPU).
An SSM model (``mamba2-2.7b``, ``tiny-ssm``) has no KV cache to page and
serves with ``--cache ring`` only; the hybrid ``zamba2-2.7b`` pages the K/V
of its shared attention block and keeps its SSM states per row, so it
serves with either cache (and never as a proxy tier's generator).  Its prefill runs the chunked scan only
for a prompt batch wider than 16 tokens; the task's prompts are shorter, so
here, as in the JAX launcher, they take the recurrent step.
The VLM ``qwen2-vl-7b`` serves text only here, as the reference's launcher
serves it (its M-RoPE positions t = h = w); image patches go in through
``ReasoningEngine.start(prompts, prompt_len, image_embeds=...)``.
``--monitor proxy`` serves black-box: a second model (``--proxy-config``,
default a twin of ``--arch``, seeded apart, or ``--proxy-ckpt``'s weights)
shadows the emitted stream and supplies the EAT exits; it must share the
generator's vocabulary.
``--overlap on`` serves through the overlapped loop
(``serving/pipeline.py``: chunk N+1 dispatched before chunk N is read); it
needs ``--requests`` and gets one chunk of capacity headroom.  The
launcher samples (temperature 0.6), and a sampled overlapped stream
differs from the sync loop's (only greedy streams are equal).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.data.synthetic import ChainTask, Tokens
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, init_params
from repro_torch.serving.cache import ATTN_IMPLS, CacheConfig
from repro_torch.serving.engine import EngineConfig, ReasoningEngine, refuse_encdec
from repro_torch.serving.proxy import ProxyConfig
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.training.checkpoint import load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-reasoner")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--delta", type=float, default=1e-3)
    ap.add_argument("--alpha", type=float, default=0.2)
    ap.add_argument("--budget", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=32,
                    help="decode steps per host round trip")
    ap.add_argument("--requests", type=int, default=0,
                    help="serve N queued requests through --batch slots "
                         "with continuous batching (0 = single batch)")
    ap.add_argument("--cache", choices=["ring", "paged"], default="ring")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="paged backend: page-pool size (0 = auto)")
    ap.add_argument("--attn-impl", choices=list(ATTN_IMPLS), default="gather")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling cutoff (0 = off)")
    ap.add_argument("--typical-p", type=float, default=1.0,
                    help="locally-typical sampling mass (1 = off)")
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="min-p sampling cutoff relative to the max-prob "
                         "token (0 = off)")
    ap.add_argument("--monitor", choices=["self", "proxy"], default="self",
                    help="EAT monitor: self (the probe inline in the decode "
                         "chunk) or proxy (black-box: a second model shadows "
                         "the emitted stream)")
    ap.add_argument("--proxy-config", default=None, metavar="ARCH",
                    help="--monitor proxy: the proxy model's architecture "
                         "(default: --arch, a twin seeded apart)")
    ap.add_argument("--ckpt", default=None,
                    help="the generator's checkpoint (default: random weights)")
    ap.add_argument("--proxy-ckpt", default=None,
                    help="--monitor proxy: the proxy's checkpoint (default: "
                         "random weights)")
    ap.add_argument("--overlap", choices=["off", "on"], default="off",
                    help="on: the overlapped serve loop (dispatch chunk N+1 "
                         "before reading chunk N; needs --requests)")
    args = ap.parse_args(argv)

    if args.monitor == "proxy" and not args.requests:
        ap.error("--monitor proxy serves through the scheduler: pass "
                 "--requests N")
    if args.overlap == "on" and not args.requests:
        ap.error("--overlap on applies to the --requests serving loop: "
                 "pass --requests N")
    if args.monitor != "proxy" and (args.proxy_config or args.proxy_ckpt):
        ap.error("--proxy-config/--proxy-ckpt only apply with --monitor proxy "
                 "(default monitor is 'self')")
    cfg = get_config(args.arch)
    refuse_encdec(cfg, "the launcher")
    if args.proxy_config:
        refuse_encdec(get_config(args.proxy_config), "the launcher's proxy tier")
    if cfg.arch_type == "ssm" and args.cache == "paged":
        ap.error(f"--arch {args.arch} is an SSM: its state has no KV capacity "
                 f"axis to page; use --cache ring")
    dev = resolve_device(args.device)
    if args.ckpt:
        params = load_checkpoint(args.ckpt, cfg, device=dev)
    else:
        print("WARNING: no checkpoint — random weights")
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    model = Model(cfg, params)
    proxy = None
    if args.monitor == "proxy":
        pcfg = get_config(args.proxy_config or args.arch)
        if pcfg.vocab != cfg.vocab:
            raise SystemExit(f"proxy arch {pcfg.name} must share the "
                             f"generator's tokenizer (vocab {cfg.vocab}, got "
                             f"{pcfg.vocab})")
        if args.proxy_ckpt:
            pparams = load_checkpoint(args.proxy_ckpt, pcfg, device=dev)
        else:
            print("WARNING: no proxy checkpoint — random proxy weights")
            pparams = init_params(pcfg, torch.Generator(device=dev).manual_seed(1),
                                  device=dev)
        proxy = ProxyConfig(model=Model(pcfg, pparams))

    ecfg = EngineConfig(
        max_reasoning_tokens=args.budget, capacity=args.budget + 128,
        pad_id=Tokens.PAD, end_think_id=Tokens.END_THINK,
        newline_id=Tokens.NEWLINE, eos_id=Tokens.EOS, chunk_len=args.chunk,
        sampler=SamplerConfig(temperature=0.6, top_p=0.95,
                              top_k=args.top_k, typical_p=args.typical_p,
                              min_p=args.min_p),
        cache=CacheConfig(attn_impl=args.attn_impl),
    )
    monitor = ReasoningMonitor(
        stopper=EATStopper(alpha=args.alpha, delta=args.delta),
        probe=make_probe(Tokens.END_THINK, (Tokens.ANS,)),
        newline_id=Tokens.NEWLINE,
    )
    task = ChainTask()
    rng = torch.Generator(device=dev).manual_seed(0)
    if args.requests:
        batch = task.serve_batch(np.random.default_rng(0), args.requests)
        # the shared ring pointer advances for the whole run, so the
        # (logical) capacity covers the batch-lifetime worst case
        ecfg.capacity = SlotScheduler.required_capacity(
            batch["prompts"].shape[1], args.requests, args.batch, args.budget)
        if args.overlap == "on":
            # the overlapped loop's ring guard adds the chunk in flight to
            # its (host-mirror) pointer estimate: give it that headroom
            ecfg.capacity += args.chunk
        ecfg.cache = CacheConfig(kind=args.cache, page_size=args.page_size,
                                 num_pages=args.num_pages,
                                 attn_impl=args.attn_impl)
        engine = ReasoningEngine(model, ecfg, monitor, proxy=proxy)
        results = engine.serve(batch["prompts"], batch["prompt_len"], rng,
                               batch_size=args.batch, answer_len=4,
                               overlap=args.overlap == "on")
        ans = np.array([ChainTask.extract_answer(r["answer_tokens"][None])[0]
                        for r in results])
        n = np.array([r["n_reasoning"] for r in results])
        print(f"served {args.requests} requests through {args.batch} slots "
              f"on {dev.type} (monitor={engine.monitor_mode})"
              + (", overlapped loop" if args.overlap == "on" else ""))
        print(f"answers: {ans}  truth: {batch['answers']}")
        print(f"correct: {(ans == batch['answers']).mean():.2f}  "
              f"reasoning tokens: total={n.sum()} per-q={n}")
        return

    engine = ReasoningEngine(model, ecfg, monitor)
    batch = task.serve_batch(np.random.default_rng(0), args.batch)
    st = engine.start(batch["prompts"], batch["prompt_len"], rng)
    st = engine.reason(st)
    toks, _ = engine.force_answer(st, 4)
    ans = ChainTask.extract_answer(toks.cpu().numpy())
    n = st.n_reasoning.cpu().numpy()
    print(f"answers: {ans}  truth: {batch['answers']}")
    print(f"correct: {(ans == batch['answers']).mean():.2f}  "
          f"reasoning tokens: total={n.sum()} per-q={n}")
    print(f"exit via EAT: {st.monitor.stop_flag.cpu().numpy()}")


if __name__ == "__main__":
    main()
