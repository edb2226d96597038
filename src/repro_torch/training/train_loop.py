"""The train step (port of ``repro/training/train_loop.py``, the one-device
part: the mesh functions ``batch_pspecs``, ``state_pspecs`` and
``jit_train_step`` wait for the port's multi-GPU layer).

``make_train_step(cfg, tcfg)`` returns ``train_step(state, batch) ->
(state, metrics)``: the loss and its gradients by autograd
(``models/model.train_loss``), then ``adamw_update``.  The step writes the
new parameters and moments into the state's tensors (the reference's step
is jitted with the state donated) and returns that state.  Its metrics are
0-dim device tensors; nothing in a step waits for the device, and the
caller reads the metrics only when it prints them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import init_params, train_loss
from repro_torch.training.optimizer import (AdamWConfig, OptState, adamw_init,
                                            adamw_update)
from repro_torch.utils.treeutil import tree_leaves


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    remat: bool = True
    z_loss: float = 1e-4


class TrainState(NamedTuple):
    params: dict          # the port's parameter tree, leaves requiring grad
    opt: OptState


def trainable(params: dict) -> dict:
    """Mark every leaf of ``params`` as requiring grad (in place)."""
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def make_train_step(model_or_cfg, tcfg: TrainConfig = TrainConfig()):
    """``model_or_cfg``: a ``ModelConfig`` or anything with a ``cfg``."""
    cfg: ModelConfig = getattr(model_or_cfg, "cfg", model_or_cfg)

    def train_step(state: TrainState, batch: dict):
        leaves = tree_leaves(state.params)
        with torch.enable_grad():
            loss, metrics = train_loss(state.params, cfg, batch,
                                       remat=tcfg.remat, z_loss=tcfg.z_loss)
            grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        _, _, opt_metrics = adamw_update(tcfg.opt, list(grads), state.opt,
                                         state.params)
        metrics.update(opt_metrics)
        return state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda") -> TrainState:
    """Seeded weights (``init_params``) made trainable, zero moments."""
    params = trainable(init_params(cfg, generator, device=device))
    return TrainState(params=params, opt=adamw_init(params))
