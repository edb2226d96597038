"""Model facade: embedding glue and the prefill / decode / probe entry
points (port of ``repro/models/model.py``).

``Model`` is an ``nn.Module`` holding the weights (frozen, inference only);
the cache is an explicit argument that the committing calls (``prefill``,
``decode_step``) update in place.  The EAT probe (``probe_entropy``) is a
forward over the probe tokens against the live cache that commits nothing,
followed by the fused entropy kernel.

Parameter tree (the JAX layout with the layer axis unstacked)::

    {"embed": {"embedding": (Vp, d), ["lm_head": (d, Vp)]},
     "final_norm": (d,),
     "layers": [{"norm1", "attn": {wq, wk, wv, wo, [q_norm, k_norm],
                                   [bq, bk, bv]},
                 "norm2", "ffn": {w_up, w_gate, w_down}}, ...]}
                # arch "ssm": [{"norm", "ssm": {w_z, w_x, w_b, w_c, w_dt,
                #   conv_x_w, conv_x_b, conv_bc_w, conv_bc_b, dt_bias, A_log,
                #   D, norm_w, out_proj}}, ...]
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels.entropy_probe.ops import next_token_entropy
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import gqa_init
from repro_torch.models.ssm import ssm_init


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Seeded random weights, made on ``device`` (the generator must live
    there too): the layout and scales of the reference's ``Model.init``."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    layers = []
    for kind in cfg.block_kinds():
        norm = common.rmsnorm_init(cfg.d_model, dtype, dev, cfg.rmsnorm_one_plus)
        if kind == "ssm":
            layers.append({"norm": norm, "ssm": ssm_init(generator, cfg, dtype, dev)})
            continue
        layers.append({
            "norm1": norm,
            "attn": gqa_init(generator, cfg, dtype, dev),
            "norm2": common.rmsnorm_init(cfg.d_model, dtype, dev, cfg.rmsnorm_one_plus),
            "ffn": common.mlp_init(generator, cfg, cfg.d_ff, dtype, dev),
        })
    return {
        "embed": common.embed_init(generator, cfg, dtype, dev),
        "final_norm": common.rmsnorm_init(cfg.d_model, dtype, dev, cfg.rmsnorm_one_plus),
        "layers": layers,
    }


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _param_dict(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in d.items()})


class Block(nn.Module):
    """One layer's weights, indexable like the JAX layer dict: a decoder
    layer (norm1, attn, norm2, ffn) or a Mamba2 layer (norm, ssm)."""

    def __init__(self, p: dict):
        super().__init__()
        for name, v in p.items():
            setattr(self, name, _param_dict(v) if isinstance(v, dict) else _frozen(v))

    def __getitem__(self, name: str):
        return getattr(self, name)


class Model(nn.Module):
    """A dense GQA decoder or a Mamba2 stack (``arch_type="ssm"``) for
    serving.

    ``attn_impl`` selects the prefill attention and ``scan_impl`` the SSM
    prefill scan (``auto``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; ``cuda``; ``plain``).  ``paged_attn_impl``
    selects the decode/probe read over a
    serving cache: ``gather`` materialises a paged cache's logical view;
    ``auto``/``cuda``/``plain`` read K/V straight off the page pools
    through the compacted page list, and a ring cache runs the same block
    algorithm with block size ``paged_attn_page`` — which must equal the
    paged cache's page size for the paged == ring bit-exactness A/B.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 attn_impl: str = "auto", paged_attn_impl: str = "gather",
                 paged_attn_page: int = 16, scan_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.scan_impl = scan_impl
        self.paged_attn_impl = paged_attn_impl
        self.paged_attn_page = paged_attn_page
        self.embed = _param_dict(params["embed"])
        self.final_norm = _frozen(params["final_norm"])
        self.layers = nn.ModuleList(Block(p) for p in params["layers"])

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # ---------------------------------------------------------------- embed
    def unembed_matrix(self) -> torch.Tensor:
        return common.unembed_matrix(self.embed, self.cfg)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return common.lm_head_apply(self.embed, hidden, self.cfg)

    def _forward(self, tokens, positions, pos1d, cache, *, commit: bool,
                 window: int | None, live=None):
        cfg = self.cfg
        window = cfg.sliding_window if window is None else window
        x = common.embed_apply(self.embed, tokens, cfg)
        slots = tfm.write_slots(cache["cur"], x.shape[1], cache["pos"].shape[1],
                                x.device)
        run = lambda: tfm.forward_cached(  # noqa: E731
            self.layers, self.final_norm, x, positions, pos1d, slots, cache,
            cfg, commit=commit, attn_impl=self.attn_impl, window=window,
            paged_impl=self.paged_attn_impl, page_block=self.paged_attn_page,
            scan_impl=self.scan_impl, live=live)
        if commit:
            return run()
        with tfm.preserved_slots(cache, slots):
            return run()

    # ---------------------------------------------------------------- serve
    def prefill(self, tokens, positions, pos1d, cache, *,
                window: int | None = None, live=None) -> torch.Tensor:
        """Fill the cache with the prompt (in place); returns hidden (B,S,d).
        ``live`` (0-dim bool) masks the commit (``forward_cached``)."""
        return self._forward(tokens, positions, pos1d, cache, commit=True,
                             window=window, live=live)

    def decode_step(self, tokens, positions, pos1d, cache, *,
                    window: int | None = None, live=None) -> torch.Tensor:
        """One committed decode step (m new tokens, usually 1), its commit
        masked by ``live`` where given.  Returns logits (B, m, Vp)."""
        hidden = self._forward(tokens, positions, pos1d, cache, commit=True,
                               window=window, live=live)
        return self.logits(hidden)

    def probe_entropy(self, probe_tokens, positions, pos1d, cache, *,
                      window: int | None = None,
                      entropy_impl: str = "auto") -> torch.Tensor:
        """EAT (paper Eq. 5/13): run the probe tokens against the cache
        WITHOUT committing it, and return the next-token entropy at the last
        probe position.  (B,) float32 nats."""
        hidden = self._forward(probe_tokens, positions, pos1d, cache,
                               commit=False, window=window)
        return next_token_entropy(hidden[:, -1].contiguous(),
                                  self.unembed_matrix(), self.cfg.vocab,
                                  impl=entropy_impl)
