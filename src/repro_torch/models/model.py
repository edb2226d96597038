"""Model facade: embedding glue, the prefill / decode / probe entry points
and the training loss (port of ``repro/models/model.py``).

``Model`` is an ``nn.Module`` holding the weights (frozen, inference only);
the cache is an explicit argument that the committing calls (``prefill``,
``decode_step``, ``decode_and_probe``) update in place.  The EAT probe
(``probe_entropy``) is a forward over the probe tokens against the live
cache that commits nothing, followed by the fused entropy kernel;
``decode_and_probe`` (the reference's §Perf step) runs one forward over
``[token, probe...]`` that commits the token alone.

Training is functional, as in the reference: ``train_loss(params, cfg,
batch)`` takes the parameter tree itself (its leaves ``requires_grad``;
``training/train_loop.py`` keeps it in a ``TrainState`` beside the
optimizer's moments, the reference's ``TrainState(params, opt)``).  No
serving ``Model`` ever builds an autograd graph: its weights stay frozen.
A trained tree serves through the same constructor as an ``init_params``
or ``from_jax`` tree, ``Model(cfg, params)``, which wraps the same storage
without gradients.

Parameter tree (the JAX layout with the layer axis unstacked)::

    {"embed": {"embedding": (Vp, d), ["lm_head": (d, Vp)]},
     "final_norm": (d,),
     "layers": [{"norm1", "attn": {wq, wk, wv, wo, [q_norm, k_norm],
                                   [bq, bk, bv]},
                 "norm2", "ffn": {w_up, w_gate, w_down}}, ...]}
                # with cfg.mla: "attn": {w_dq, q_norm, w_uq, w_dkv, kv_norm,
                #   w_kr, w_uk, w_uv, wo} (multi-head latent attention)
                # arch "moe": layers from first_k_dense on hold "moe":
                #   {"router": (d, E) float32, "experts": {w_up, w_gate,
                #   w_down: (E, d_in, d_out)}, ["shared": {w_up, w_gate,
                #   w_down}]} in place of "ffn"; the first ones an "ffn" of
                #   width dense_d_ff (the reference's dense_layers then
                #   moe_layers, one flat list here)
                # arch "ssm": [{"norm", "ssm": {w_z, w_x, w_b, w_c, w_dt,
                #   conv_x_w, conv_x_b, conv_bc_w, conv_bc_b, dt_bias, A_log,
                #   D, norm_w, out_proj}}, ...]
                # arch "hybrid": the SSM blocks only, in block order (the
                #   reference's (G, n_per) groups, flattened), and beside
                # arch "vlm": the dense layout, with qkv bias
                # arch "encdec": the decoder's layers, each also holding
                #   "norm_c" and "cross": {wq, wk, wv, wo} (cross-attention)
     ["shared_attn": {"norm1": (2 d,), "attn": {wq, wk, wv: (2 d, .), wo},
                      "norm2", "ffn"}],  # the one shared attention block
     ["enc_layers": [{"norm1", "attn", "norm2", "ffn"}, ...],
      "enc_norm": (d,)]}                 # arch "encdec": the encoder
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels.entropy_probe.ops import next_token_entropy
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import cross_attn_init, cross_attn_kv, gqa_init, mla_init
from repro_torch.models.moe import moe_init
from repro_torch.models.ssm import ssm_init


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda") -> dict:
    """Seeded random weights, made on ``device`` (the generator must live
    there too): the layout and scales of the reference's ``Model.init``."""
    return build_params(cfg, generator, resolve_device(device))


def build_params(cfg: ModelConfig, generator, dev: torch.device) -> dict:
    """``init_params`` on a resolved device; on the ``meta`` device (with
    no generator) it gives every leaf's shape and dtype without memory."""
    dtype = torch_dtype(cfg.dtype)
    dense_ff = (cfg.moe.dense_d_ff or cfg.d_ff) if cfg.moe is not None else cfg.d_ff
    def norm(d: int) -> torch.Tensor:
        return common.rmsnorm_init(d, dtype, dev, cfg.rmsnorm_one_plus)

    def attn_block(use_moe: bool, d_in: int, cross: bool = False) -> dict:
        layer = {
            "norm1": norm(d_in),
            "attn": (mla_init(generator, cfg, dtype, dev) if cfg.mla is not None
                     else gqa_init(generator, cfg, dtype, dev, d_in=d_in)),
            "norm2": norm(cfg.d_model),
        }
        if cross:
            layer["norm_c"] = norm(cfg.d_model)
            layer["cross"] = cross_attn_init(generator, cfg, dtype, dev)
        if use_moe:
            layer["moe"] = moe_init(generator, cfg, dtype, dev)
        else:
            layer["ffn"] = common.mlp_init(generator, cfg, dense_ff, dtype, dev)
        return layer

    encdec = cfg.arch_type == "encdec"
    layers = []
    for kind, use_moe in zip(cfg.block_kinds(), cfg.moe_layer_mask()):
        if kind == "ssm":
            layers.append({"norm": norm(cfg.d_model),
                           "ssm": ssm_init(generator, cfg, dtype, dev)})
        elif kind == "attn":
            layers.append(attn_block(use_moe, cfg.d_model, cross=encdec))
    params = {
        "embed": common.embed_init(generator, cfg, dtype, dev),
        "final_norm": norm(cfg.d_model),
        "layers": layers,
    }
    if "shared_attn" in cfg.block_kinds():
        params["shared_attn"] = attn_block(False, 2 * cfg.d_model)
    if encdec:
        params["enc_layers"] = [attn_block(False, cfg.d_model)
                                for _ in range(cfg.n_encoder_layers)]
        params["enc_norm"] = norm(cfg.d_model)
    return params


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _param_dict(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in d.items()})


class Block(nn.Module):
    """One layer's weights, indexable like the JAX layer dict: a decoder
    layer (norm1, attn, norm2, ffn or moe) or a Mamba2 layer (norm, ssm).
    A dict of weights is a ``ParameterDict``; a dict of dicts (the MoE's,
    whose experts are a dict) a nested ``Block``."""

    def __init__(self, p: dict):
        super().__init__()
        for name, v in p.items():
            if not isinstance(v, dict):
                setattr(self, name, _frozen(v))
            elif any(isinstance(x, dict) for x in v.values()):
                setattr(self, name, Block(v))
            else:
                setattr(self, name, _param_dict(v))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._modules or name in self._parameters


class Model(nn.Module):
    """A dense GQA decoder, a mixture-of-experts decoder (``arch_type=
    "moe"``), either with multi-head latent attention (``cfg.mla``), a
    Mamba2 stack (``arch_type="ssm"``), a Zamba2-style hybrid
    (``arch_type="hybrid"``: Mamba2 blocks and one shared attention block,
    ``shared_attn``) or an encoder-decoder (``arch_type="encdec"``: the
    bidirectional encoder ``enc_layers`` + ``enc_norm`` over stub frames,
    run once per prefill, and a decoder whose blocks cross-attend to it)
    or a VLM's language backbone (``arch_type="vlm"``: the dense decoder
    with M-RoPE, stub patch embeddings in front of a prompt) for serving.

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
        self.shared_attn = (Block(params["shared_attn"]) if "shared_attn" in params
                            else None)
        self.enc_layers = nn.ModuleList(Block(p) for p in params.get("enc_layers", []))
        self.enc_norm = (_frozen(params["enc_norm"]) if "enc_norm" in params
                         else None)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    # ---------------------------------------------------------------- embed
    def unembed_matrix(self) -> torch.Tensor:
        return common.unembed_matrix(self.embed, self.cfg)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return common.lm_head_apply(self.embed, hidden, self.cfg)

    def _forward(self, tokens, positions, pos1d, cache, *, commit: bool,
                 window: int | None, live=None, image_embeds=None,
                 advance: int | None = None):
        cfg = self.cfg
        window = cfg.sliding_window if window is None else window
        x = embed_stream(self.embed, cfg, tokens, image_embeds)
        slots = tfm.write_slots(cache["cur"], x.shape[1], cache["pos"].shape[1],
                                x.device)
        run = lambda: tfm.forward_cached(  # noqa: E731
            self.layers, self.final_norm, x, positions, pos1d, slots, cache,
            cfg, commit=commit, advance=advance, attn_impl=self.attn_impl,
            window=window,
            paged_impl=self.paged_attn_impl, page_block=self.paged_attn_page,
            scan_impl=self.scan_impl, live=live, shared=self.shared_attn)
        if commit:
            return run()
        with tfm.preserved_slots(cache, slots):
            return run()

    # ---------------------------------------------------------------- serve
    def prefill(self, tokens, positions, pos1d, cache, *, frames=None,
                image_embeds=None, window: int | None = None,
                live=None) -> torch.Tensor:
        """Fill the cache with the prompt (in place); returns hidden (B,S,d).
        ``live`` (0-dim bool) masks the commit (``forward_cached``).  An
        encoder-decoder needs ``frames`` (B, T, d): they are encoded, and
        each decoder layer's cross K/V and the cache's ``enc_pos`` are
        copied into the cache's own tensors first.  A VLM may take
        ``image_embeds`` (B, P, d), put in front of the tokens: positions,
        pos1d and the hidden states then cover P + S slots, and the patches'
        K/V land in the cache's own slots like the prompt's."""
        if self.cfg.arch_type == "encdec":
            self._encode_into(frames, cache)
        return self._forward(tokens, positions, pos1d, cache, commit=True,
                             window=window, live=live, image_embeds=image_embeds)

    def _encode_into(self, frames, cache) -> None:
        """Encode ``frames`` (B, T, d) with ``enc_pos = arange(T)`` and write
        every decoder layer's cross K/V and ``enc_pos`` into ``cache``'s
        tensors with ``copy_``: a chunk graph captured over the cache reads
        the new frames' K/V at its next replay."""
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: its "
                             f"prefill needs frames (B, T, d_model)")
        cfg = self.cfg
        B, T, _ = frames.shape
        if tuple(cache["enc_pos"].shape) != (B, T):
            raise ValueError(f"frames {tuple(frames.shape)} against a cache "
                             f"for {tuple(cache['enc_pos'].shape)} frames")
        enc_pos = torch.arange(T, dtype=torch.int32,
                               device=frames.device).expand(B, T).contiguous()
        x = frames.to(self.final_norm.dtype)
        enc_out = tfm.encode(self.enc_layers, self.enc_norm, x, enc_pos, cfg,
                             attn_impl=self.attn_impl)
        for p, entry in zip(self.layers, cache["layers"]):
            ck, cv = cross_attn_kv(p["cross"], enc_out, cfg)
            entry["ck"].copy_(ck)
            entry["cv"].copy_(cv)
        cache["enc_pos"].copy_(enc_pos)

    def decode_step(self, tokens, positions, pos1d, cache, *,
                    window: int | None = None, live=None) -> torch.Tensor:
        """One committed decode step (m new tokens, usually 1), its commit
        masked by ``live`` where given.  Returns logits (B, m, Vp)."""
        hidden = self._forward(tokens, positions, pos1d, cache, commit=True,
                               window=window, live=live)
        return self.logits(hidden)

    def decode_and_probe(self, token, positions, pos1d, cache, probe_tokens, *,
                         window: int | None = None, entropy_impl: str = "auto"):
        """The fused serve step: ONE forward over ``[token, probe...]``
        instead of a decode step and a separate probe, so the weights are
        read once per step.  It commits the token alone: the K/V and
        positions of all 1 + m slots are written and ``cur`` advances by 1;
        the probe's entries stay in the slots after ``cur``, masked by
        position until the next steps overwrite them.  With a sliding-window ring the probe writes take
        the m oldest window slots (the window is then effectively W - m).
        On a paged cache, probe slots past a row's mapped pages send their
        K/V to the trash page (their positions to the row's ``pos``), as
        the reference's page-table write does: the gathered read reads them
        back from there, the page-native read skips the trash page, so the
        probe rows then miss the probe's own K/V, as in the reference.

        token (B, 1); probe_tokens (B, m); positions/pos1d over the 1 + m
        slots ((B, 1 + m, 3) positions under M-RoPE).  Returns (logits (B,
        1, Vp) of the token's row, the EAT (B,) float32 of the last probe
        row).  A recurrent stack (``ssm``, ``hybrid``) would bake the probe
        into its states, so it runs ``decode_step`` then ``probe_entropy``
        instead, as the reference does."""
        cfg = self.cfg
        m = probe_tokens.shape[1]
        if cfg.arch_type in ("ssm", "hybrid"):
            # contiguous slices: the kernels' wrappers take no strided positions
            logits = self.decode_step(token, positions[:, :1].contiguous(),
                                      pos1d[:, :1].contiguous(), cache,
                                      window=window)
            eat = self.probe_entropy(probe_tokens, positions[:, 1:1 + m].contiguous(),
                                     pos1d[:, 1:1 + m].contiguous(), cache,
                                     window=window, entropy_impl=entropy_impl)
            return logits, eat
        hidden = self._forward(torch.cat([token, probe_tokens], dim=1), positions,
                               pos1d, cache, commit=True, window=window, advance=1)
        eat = next_token_entropy(hidden[:, -1].contiguous(), self.unembed_matrix(),
                                 cfg.vocab, impl=entropy_impl)
        return self.logits(hidden[:, :1]), eat

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


# ------------------------------------------------------------------ train


def embed_stream(embed, cfg: ModelConfig, tokens, image_embeds=None) -> torch.Tensor:
    """``embed_apply`` of ``tokens``, with a VLM's ``image_embeds`` (B, P, d)
    cast to the embeddings' dtype and put in front (B, P + S, d): the
    reference's ``Model.embed_stream``."""
    x = common.embed_apply(embed, tokens, cfg)
    if cfg.arch_type == "vlm" and image_embeds is not None:
        x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
    return x


def train_logits(params: dict, cfg: ModelConfig, tokens, positions, pos1d, *,
                 remat: bool = True, window: int | None = None,
                 image_embeds=None, frames=None) -> torch.Tensor:
    """The training forward (no cache; plain attention and scan, as the
    reference's trainer): (logits (B, S, Vp) in the storage dtype, the
    MoE layers' summed aux loss, 0-dim float32).  A VLM's
    ``image_embeds`` (B, P, d) go in front of the tokens; ``positions``
    ((B, P + S, 3) with M-RoPE) and ``pos1d`` then cover both.  An
    encoder-decoder's ``frames`` (B, T, d) are encoded first (under
    ``remat`` too, with ``enc_pos = arange(T)``) and every decoder block
    cross-attends to the encoder's output."""
    window = cfg.sliding_window if window is None else window
    x = embed_stream(params["embed"], cfg, tokens, image_embeds)
    enc_out = enc_pos = None
    if cfg.arch_type == "encdec":
        B, T, _ = frames.shape
        enc_pos = torch.arange(T, dtype=torch.int32,
                               device=frames.device).expand(B, T).contiguous()
        enc_out = tfm.encode(params["enc_layers"], params["enc_norm"],
                             frames.to(x.dtype), enc_pos, cfg, attn_impl="plain",
                             remat=remat)
    hidden, aux = tfm.forward_train(params["layers"], params["final_norm"], x,
                                    positions, pos1d, cfg, valid=pos1d >= 0,
                                    remat=remat, window=window,
                                    shared=params.get("shared_attn"),
                                    enc_out=enc_out, enc_pos=enc_pos)
    return common.lm_head_apply(params["embed"], hidden, cfg), aux


def train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
               remat: bool = True, z_loss: float = 1e-4,
               window: int | None = None):
    """batch: tokens (B, S); targets, loss_mask, pos1d (B, S_total);
    positions (B, S_total), or (B, S_total, 3) for an M-RoPE config; a
    VLM's optional image_embeds (B, P, d), put in front of the tokens
    (S_total = P + S); an encoder-decoder's frames (B, T, d), which it
    needs; tensors on the parameters' device.  Returns (loss, metrics dict
    of 0-dim device tensors: ce, z_loss, accuracy, tokens, loss, and for an
    MoE config aux_loss, which the loss carries times
    ``router_aux_weight``)."""
    unknown = set(batch) - {"tokens", "targets", "loss_mask", "positions", "pos1d",
                            "image_embeds", "frames"}
    if unknown:
        raise ValueError(f"batch keys {sorted(unknown)} are not training inputs")
    if "image_embeds" in batch and cfg.arch_type != "vlm":
        raise ValueError(f"{cfg.name} is not a VLM: it takes no image_embeds")
    if ("frames" in batch) != (cfg.arch_type == "encdec"):
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its batch needs frames (B, T, d_model)"
            if cfg.arch_type == "encdec" else
            f"{cfg.name} is not an encoder-decoder: it takes no frames")
    logits, aux = train_logits(params, cfg, batch["tokens"], batch["positions"],
                               batch["pos1d"], remat=remat, window=window,
                               image_embeds=batch.get("image_embeds"),
                               frames=batch.get("frames"))
    loss, metrics = cross_entropy_loss(logits, batch["targets"],
                                       batch["loss_mask"], cfg.vocab,
                                       z_loss=z_loss)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
        metrics["aux_loss"] = aux
    metrics["loss"] = loss
    return loss, metrics


def cross_entropy_loss(logits, targets, mask, vocab: int, *,
                       z_loss: float = 1e-4):
    """Masked CE over the valid vocabulary (padding columns excluded) plus
    the z-loss on log Z, in float32.  The max is detached (the reference's
    ``stop_gradient``), so the z-loss gradient flows through log Z alone;
    the target's log-probability is a gather, which equals the reference's
    one-hot contraction exactly."""
    Vp = logits.shape[-1]
    lf = logits.float()
    col_valid = torch.arange(Vp, device=lf.device) < vocab
    lf = torch.where(col_valid, lf, -1e30)
    m = lf.amax(dim=-1, keepdim=True).detach()
    shifted = lf - m
    logz = torch.log(torch.exp(shifted).sum(dim=-1))                # (B, S)
    ll = shifted.gather(-1, targets.long()[..., None])[..., 0] - logz
    maskf = mask.float()
    denom = maskf.sum().clamp_min(1.0)
    ce = -(ll * maskf).sum() / denom
    zl = ((logz + m[..., 0]) ** 2 * maskf).sum() / denom
    loss = ce + z_loss * zl
    acc = ((lf.argmax(dim=-1) == targets) * maskf).sum() / denom
    return loss, {"ce": ce, "z_loss": zl, "accuracy": acc, "tokens": maskf.sum()}
