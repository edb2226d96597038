"""Parameter bridge from the JAX reference.

``from_jax`` takes the pytree of the reference's ``Model.init`` as nested
dicts of numpy arrays and returns the port's parameter tree
(``models/model.py``) on ``device``.  Weights keep JAX's ``(d_in, d_out)``
layout, so this copies and never transposes; the only reshaping is
unstacking the leading ``(L, ...)`` layer axis that the reference's
``init_stack`` builds.  A tied config simply has no ``lm_head``: the port
unembeds through the transposed embedding view, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype


def from_jax(np_tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def t(a) -> torch.Tensor:
        # numpy has no bfloat16: bf16 leaves arrive as float32 copies
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dev, dtype)

    emb = np_tree["embed"]
    embed = {"embedding": t(emb["embedding"])}
    if not cfg.tie_embeddings:
        embed["lm_head"] = t(emb["lm_head"])
    stack = np_tree["stack"]
    lay = stack["layers"]
    layers = []
    for i in range(cfg.n_layers):
        layers.append({
            "norm1": t(lay["norm1"][i]),
            "attn": {k: t(v[i]) for k, v in lay["attn"].items()},
            "norm2": t(lay["norm2"][i]),
            "ffn": {k: t(v[i]) for k, v in lay["ffn"].items()},
        })
    return {"embed": embed, "final_norm": t(stack["final_norm"]),
            "layers": layers}
