"""Checkpoints in the reference's format (port of
``repro/training/checkpoint.py``), readable and writable by either package.

A file is ``msgpack.packb(payload, use_bin_type=True)`` of one map from
each leaf's path in the reference's layout (``embed/embedding``,
``stack/final_norm``, ``stack/layers/attn/wq``, ...; layer leaves stacked
``(L, ...)``; paths in ``jax.tree_util``'s order) to ``{"dtype": numpy's
dtype name, "shape": [...], "data": the C-order bytes}``.  The codec is
``utils/msgpack.py`` (the subset such a file holds), so the port needs no
``msgpack`` package; the same parameters give the same bytes as the
reference's writer.
"""
from __future__ import annotations

import os

from repro_torch.configs.base import ModelConfig
from repro_torch.params import (dtype_name, leaf_bytes, leaf_from_bytes,
                                param_specs, to_jax, unstack)
from repro_torch.utils import msgpack
from repro_torch.utils.treeutil import tree_flatten_with_paths


def save_checkpoint(path: str, params: dict, cfg: ModelConfig) -> None:
    """Write the port's parameter tree ``params`` of ``cfg`` to ``path``."""
    payload = {}
    for key, leaf in tree_flatten_with_paths(to_jax(params, cfg)):
        payload[key] = {"dtype": dtype_name(leaf), "shape": list(leaf.shape),
                        "data": leaf_bytes(leaf)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(payload))


def load_checkpoint(path: str, cfg: ModelConfig, device="cuda") -> dict:
    """The parameter tree of ``cfg`` stored at ``path``, on ``device``.
    Every leaf's shape and dtype is checked against the config; a missing
    or unknown leaf raises."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read())
    specs = param_specs(cfg)
    if set(payload) != set(specs):
        raise ValueError(
            f"{path} does not hold {cfg.name}'s parameters: missing "
            f"{sorted(set(specs) - set(payload))}, unknown "
            f"{sorted(set(payload) - set(specs))}")
    stacked: dict = {}
    for key, (shape, dtype) in specs.items():
        rec = payload[key]
        if (tuple(rec["shape"]), rec["dtype"]) != (shape, dtype):
            raise ValueError(f"{path}: {key} is {rec['dtype']}{rec['shape']}, "
                             f"{cfg.name} needs {dtype}{list(shape)}")
        node = stacked
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = leaf_from_bytes(rec["data"], dtype, shape)
    return unstack(stacked, cfg, device)
