"""Parameter bridge to and from the JAX reference's layout.

The port keeps one dict per layer (``models/model.py``); the reference
stacks every layer leaf along a leading ``(L, ...)`` axis
(``transformer.init_stack``) under ``{"embed": ..., "stack": {"layers",
"final_norm"}}``; an MoE config stacks its first ``first_k_dense`` layers
under ``stack/dense_layers`` and the rest under ``stack/moe_layers`` (no
``dense_layers`` when there are none), which the port keeps as one flat
list, dense layers first.  A hybrid stacks its SSM blocks under
``stack/groups`` with two leading axes ``(G, n_per, ...)`` (G groups of
``n_per`` SSM blocks, flattened in block order into the port's list) and
keeps its one shared attention block, unstacked, under
``stack/shared_attn`` (the port's ``shared_attn``).  An encoder-decoder
stacks its decoder layers (each with ``norm_c`` and ``cross``) under
``stack/dec_layers`` (the port's ``layers``), its encoder layers under
``stack/enc_layers`` (the port's ``enc_layers``) and keeps ``enc_norm``
under ``stack/enc_norm``.  A VLM's tree is the dense one (``stack/layers``,
with qkv bias).  Expert leaves keep
their ``(E, d_in, d_out)`` layout under the layer axis; an MLA layer's ``attn`` holds the reference's
nine leaves (``w_dq``, ``q_norm``, ``w_uq``, ``w_dkv``, ``kv_norm``,
``w_kr``, ``w_uk``, ``w_uv``, ``wo``), carried like any other.
Weights keep JAX's ``(d_in, d_out)`` layout on both
sides, so nothing is transposed.  A tied config has no ``lm_head``: the
port unembeds through the transposed embedding view, as the reference does.
Each leaf keeps its own dtype: a bfloat16 model's SSM ``dt_bias``,
``A_log`` and ``D`` are float32 in the reference and stay so.

* ``from_jax`` takes the reference's pytree as nested dicts of numpy arrays
  (the parity tests' bridge) and returns the port's tree on ``device``.
* ``to_jax`` is its inverse: the reference's stacked layout as CPU tensors
  in each leaf's own dtype.  numpy has no bfloat16 of its own, so the
  reference's numpy form of a bf16 leaf is its raw 16-bit pattern
  (``leaf_bytes`` / ``leaf_from_bytes``, the checkpoint format's).
* ``param_specs`` gives the reference's path, shape and dtype of every leaf
  of a config, without building the weights.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.utils.treeutil import tree_flatten_with_paths, tree_map

#: the dtypes a parameter file may hold: numpy's names, the storage numpy
#: reads the bytes as, and the torch dtype
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (np.int16, torch.bfloat16)}


def dtype_name(t: torch.Tensor) -> str:
    name = str(t.dtype).removeprefix("torch.")
    if name not in DTYPES:
        raise TypeError(f"parameters are float32 or bfloat16, got {t.dtype}")
    return name


def leaf_bytes(t: torch.Tensor) -> bytes:
    """A tensor's C-order bytes, as numpy's ``tobytes`` gives them for the
    reference's array (bf16 through its int16 bit pattern)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def leaf_from_bytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    """The inverse of ``leaf_bytes``: a CPU tensor of ``dtype`` (a numpy
    dtype name) and ``shape``."""
    np_dtype, t_dtype = DTYPES[dtype]
    arr = np.frombuffer(data, dtype=np_dtype).reshape(shape).copy()
    return torch.from_numpy(arr).view(t_dtype)


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
        raise ValueError(f"the port has no {cfg.arch_type!r} model "
                         f"(dense, vlm, moe, ssm, hybrid and encdec only)")


def _segments(cfg: ModelConfig) -> list[tuple[str, int, tuple[int, ...]]]:
    """The reference's stacked layer groups: (key under ``stack``, first
    entry of the port's ``layers``, the leaves' leading axes)."""
    if cfg.arch_type == "hybrid":
        pat = cfg.hybrid_pattern
        n_per = sum(1 for k in pat if k == "ssm")
        return [("groups", 0, (cfg.n_layers // len(pat), n_per))]
    if cfg.arch_type == "encdec":
        return [("dec_layers", 0, (cfg.n_layers,))]
    if cfg.arch_type != "moe":
        return [("layers", 0, (cfg.n_layers,))]
    fk = cfg.moe.first_k_dense
    segs = [("dense_layers", 0, (fk,))] if fk else []
    return segs + [("moe_layers", fk, (cfg.n_layers - fk,))]


def unstack(stacked: dict, cfg: ModelConfig, device) -> dict:
    """The reference's layout (tensors, layer leaves ``(L, ...)``) -> the
    port's parameter tree on ``device``."""
    _check_arch(cfg)
    dev = resolve_device(device)

    def own(t: torch.Tensor) -> torch.Tensor:     # never the input's storage
        return t.to(dev, copy=True)

    def tree(d: dict, n_lead: int, i: int) -> dict:
        return {k: tree(v, n_lead, i) if isinstance(v, dict)
                else own(v.flatten(0, n_lead - 1)[i]) for k, v in d.items()}

    emb = stacked["embed"]
    embed = {"embedding": own(emb["embedding"])}
    if not cfg.tie_embeddings:
        embed["lm_head"] = own(emb["lm_head"])
    stack = stacked["stack"]
    layers = [tree(stack[key], len(lead), i) for key, _, lead in _segments(cfg)
              for i in range(math.prod(lead))]
    out = {"embed": embed, "final_norm": own(stack["final_norm"]),
           "layers": layers}
    if cfg.arch_type == "hybrid":
        out["shared_attn"] = tree_map(own, stack["shared_attn"])
    if cfg.arch_type == "encdec":
        out["enc_layers"] = [tree(stack["enc_layers"], 1, i)
                             for i in range(cfg.n_encoder_layers)]
        out["enc_norm"] = own(stack["enc_norm"])
    return out



def from_jax(np_tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    def t(a) -> torch.Tensor:
        # numpy knows bfloat16 only through ml_dtypes: go through float32
        a = np.asarray(a)
        dtype = torch_dtype(a.dtype.name)
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    def tree(d: dict) -> dict:
        return {k: tree(v) if isinstance(v, dict) else t(v) for k, v in d.items()}

    return unstack(tree(np_tree), cfg, device)


def to_jax(params: dict, cfg: ModelConfig) -> dict:
    """The port's tree -> the reference's layout, as CPU tensors in each
    leaf's dtype (layer leaves stacked along a new leading axis)."""
    _check_arch(cfg)
    layers = params["layers"]
    want = sum(math.prod(lead) for _, _, lead in _segments(cfg))
    if len(layers) != want:
        raise ValueError(f"{cfg.name} has {want} stacked layers, the tree "
                         f"{len(layers)}")
    host = lambda t: t.detach().cpu()  # noqa: E731

    def stack(ds: list, lead: tuple[int, ...]) -> dict:
        return {k: stack([d[k] for d in ds], lead) if isinstance(ds[0][k], dict)
                else torch.stack([host(d[k]) for d in ds]).reshape(
                    lead + tuple(ds[0][k].shape)) for k in ds[0]}

    out = {"final_norm": host(params["final_norm"])}
    for key, i0, lead in _segments(cfg):
        out[key] = stack(list(layers[i0:i0 + math.prod(lead)]), lead)
    if cfg.arch_type == "hybrid":
        out["shared_attn"] = tree_map(host, params["shared_attn"])
    if cfg.arch_type == "encdec":
        if len(params["enc_layers"]) != cfg.n_encoder_layers:
            raise ValueError(f"{cfg.name} has {cfg.n_encoder_layers} encoder "
                             f"layers, the tree {len(params['enc_layers'])}")
        out["enc_layers"] = stack(list(params["enc_layers"]),
                                  (cfg.n_encoder_layers,))
        out["enc_norm"] = host(params["enc_norm"])
    return {"embed": {k: host(v) for k, v in params["embed"].items()},
            "stack": out}


def param_specs(cfg: ModelConfig) -> dict[str, tuple[tuple[int, ...], str]]:
    """{reference path: (shape, dtype name)} of every leaf of ``cfg``."""
    from repro_torch.models.model import build_params

    _check_arch(cfg)
    meta = build_params(cfg, None, torch.device("meta"))
    spec = lambda t, lead=(): ((*lead, *t.shape), dtype_name(t))  # noqa: E731
    specs = {f"embed/{k}": spec(t) for k, t in meta["embed"].items()}
    specs["stack/final_norm"] = spec(meta["final_norm"])
    for key, i0, lead in _segments(cfg):
        for path, t in tree_flatten_with_paths(meta["layers"][i0]):
            specs[f"stack/{key}/{path}"] = spec(t, lead)
    for path, t in tree_flatten_with_paths(meta.get("shared_attn", {})):
        specs[f"stack/shared_attn/{path}"] = spec(t)
    if cfg.arch_type == "encdec":
        for path, t in tree_flatten_with_paths(meta["enc_layers"][0]):
            specs[f"stack/enc_layers/{path}"] = spec(t, (cfg.n_encoder_layers,))
        specs["stack/enc_norm"] = spec(meta["enc_norm"])
    return specs
