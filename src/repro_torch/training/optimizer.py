"""AdamW + cosine schedule + global-norm clipping (port of
``repro/training/optimizer.py``), the reference's arithmetic exactly.

The moments ``m`` and ``v`` are float32 whatever the parameter dtype (the
usual mixed-precision layout) and mirror the parameter tree.  Every update
is computed in float32 and cast back to the parameter's dtype.  The step
count is a 0-dim int32 device tensor, and the learning rate and bias
corrections are computed from it on the device: a step reads nothing back
to the host.  (``torch.optim.AdamW`` keeps its moments in the parameter's
dtype and has neither the clip nor the schedule.)

``adamw_update`` writes the new parameters and moments into the tensors it
is given, as the reference's jitted step donates its state: the state's
memory is held once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.utils.treeutil import tree_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor      # 0-dim int32, on the parameters' device
    m: dict
    v: dict


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine to ``min_lr_ratio`` × ``lr``
    (float32, on ``step``'s device)."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like_tree(v) for v in tree]
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def adamw_init(params: dict) -> OptState:
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=_zeros_like_tree(params), v=_zeros_like_tree(params))


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf."""
    total = sum(torch.sum(torch.square(g.float())) for g in leaves)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: list, opt: OptState, params: dict):
    """One AdamW step.  ``grads``: one tensor per leaf of ``params``, in
    ``tree_leaves`` order.  Updates ``params``, ``opt.m``, ``opt.v`` and
    ``opt.step`` in place; returns (params, opt, {"grad_norm", "lr"})."""
    flat_p, flat_m, flat_v = (tree_leaves(t) for t in (params, opt.m, opt.v))
    if not len(flat_p) == len(grads) == len(flat_m) == len(flat_v):
        raise ValueError(f"{len(grads)} gradients for {len(flat_p)} parameters")
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    opt.step.add_(1)
    lr = cosine_schedule(cfg, opt.step)
    sf = opt.step.float()
    b1c = 1 - torch.pow(cfg.b1, sf)
    b2c = 1 - torch.pow(cfg.b2, sf)
    for p, g, m, v in zip(flat_p, grads, flat_m, flat_v):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mh, vh = m / b1c, v / b2c
        pf = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, opt, {"grad_norm": gnorm, "lr": lr}
