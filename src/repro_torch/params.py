"""Parameter bridge from the JAX reference.

``from_jax`` takes the pytree of the reference's ``Model.init`` as nested
dicts of numpy arrays and returns the port's parameter tree
(``models/model.py``) on ``device``.  Weights keep JAX's ``(d_in, d_out)``
layout, so this copies and never transposes; the only reshaping is
unstacking the leading ``(L, ...)`` layer axis that the reference's
``init_stack`` builds.  A tied config simply has no ``lm_head``: the port
unembeds through the transposed embedding view, as the reference does.
Each leaf keeps its own dtype: a bfloat16 model's SSM ``dt_bias``,
``A_log`` and ``D`` are float32 in the reference and stay so.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype


def from_jax(np_tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        # numpy knows bfloat16 only through ml_dtypes: go through float32
        a = np.asarray(a)
        dtype = torch_dtype(a.dtype.name)
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    def tree(d: dict, i: int) -> dict:
        return {k: tree(v, i) if isinstance(v, dict) else t(v[i])
                for k, v in d.items()}

    emb = np_tree["embed"]
    embed = {"embedding": t(emb["embedding"])}
    if not cfg.tie_embeddings:
        embed["lm_head"] = t(emb["lm_head"])
    stack = np_tree["stack"]
    lay = stack["layers"]
    layers = [tree(lay, i) for i in range(cfg.n_layers)]
    return {"embed": embed, "final_norm": t(stack["final_norm"]),
            "layers": layers}
