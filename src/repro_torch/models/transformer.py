"""The cached forward of a dense GQA decoder, a mixture-of-experts decoder
(either with multi-head latent attention, ``cfg.mla``), a Mamba2 stack, a
Zamba2-style hybrid and an encoder-decoder's decoder, the encoder-decoder's
bidirectional encoder, and the training forward of all of them (port
of the dense, MoE, MLA, SSM, hybrid and encdec branches of
``repro/models/transformer.py``: ``write_slots``, the paged-cache helpers,
``page_native_ok``, ``attn_block_cached``, ``attn_block_full``,
``ssm_block_full`` / ``ssm_block_step``, ``encode``, ``forward_cached`` and
``forward_train``).  An MoE
layer (one holding ``moe``) runs ``models/moe.py``'s ``moe_apply`` where a
dense layer runs its MLP; the reference's ``dense_seg`` and ``moe_seg`` are
one flat list of layers and cache entries here.  An MLA layer caches its
latent ``c`` and rope key ``kr`` and reads them in the absorbed form for
every query width; a paged cache's pools are gathered into the logical
view for it (never the page-native read, as in the reference).

Every stack is walked block by block in ``cfg.block_kinds()`` order, one
cache entry per block.  A hybrid's ``layers`` are its SSM blocks alone
(the reference's ``(G, n_per)`` groups, flattened); each ``shared_attn``
block runs the one ``shared`` weight set on ``concat(x, emb0)`` (``emb0``
the embedded stream, 2 d wide into ``norm1`` and the q/k/v projections;
the residual adds onto ``x`` alone) against its own K/V entry.

An encoder-decoder (``arch_type="encdec"``): ``encode`` runs the encoder's
blocks over the stub frames, bidirectionally (``causal=False``, positions
and RoPE at ``enc_pos = arange(T)``), then ``enc_norm``; each decoder block
attends to itself, then (``norm_c``) to the encoder's output through its
entry's cross K/V ``ck``/``cv`` at the cache's ``enc_pos``
(``attention.cross_attention``, every query at position 0, not causal),
then runs its MLP.  The cross K/V are written once, at prefill; no cached forward
here writes them.  Training (``forward_train`` with ``enc_out``) makes each
decoder block's cross K/V from the encoder's output in the call, as the
reference's trainer does.

``forward_train`` runs the plain attention and the plain SSD scan, as the
reference's trainer does (its ``Model(cfg, attn_impl="xla")`` and
``ssd_chunked``): no kernel of the port has a backward.

Cache layout (built in ``serving/cache.py``)::

    {"layers": [ {"k", "v"} per layer ],   # ring: (B, C, Hkv, hd) each
                                           # paged: pools (P, ps, Hkv, hd)
              | [ {"c", "kr"} per layer ], # MLA: (B, C, kv_lora), (B, C,
                                           # rope_d); paged: (P, ps, ...)
              | [ {"ssm", "conv": {"x", "bc"}} per layer ],   # arch "ssm"
              | both, in block order                          # arch "hybrid"
              | [ {"k", "v", "ck", "cv"} per layer ],         # arch "encdec":
                       # ck/cv (B, T, Hkv, hd), dense in a paged cache too
     "pos": (B, C) int32 slot positions (-1 = empty),
     ["enc_pos": (B, T) int32 frame positions (arch "encdec")],
     "cur": 0-dim int64 committed length (the shared ring pointer),
     ["page_table": (B, NB) int32, "blocks": {"pages","logical","count"}]}

The JAX reference is pure: a probe's forward returns a new cache that the
caller drops.  Here K/V are written into the cache tensors in place, so a
non-committing forward (``commit=False``) builds its ``kv_pos`` as a new
tensor and leaves ``pos`` and ``cur`` alone, and ``preserved_slots`` puts
back the slots (K/V or latents) such a forward overwrites.  ``cur`` stays
on the device: nothing here reads device data on the host.  A recurrent
state has no slots: an SSM layer returns a new state, and only a
committing forward puts it in the cache (replacing the layer's entry,
never writing into its tensors), so a probe or a rollout leaves the live
state as it was.

A committing forward may advance ``cur`` by fewer slots than it writes
(``advance``): the fused decode-and-probe step writes the K/V and
positions of its token and its probe tokens and commits the token alone
(``cur`` += 1).  The probe's entries stay in the slots after ``cur``,
masked by their positions (later than any query until the next steps
overwrite them), as in the reference's ``Model.decode_and_probe``.

A committing forward may be masked by ``live``, a 0-dim bool device tensor
(the masked decode step of a chunk run as one CUDA graph): where it is
false, every slot write (``pos``, K/V, latents) puts back the value it
replaces and ``cur`` advances by 0, so the forward leaves the cache
exactly as it was.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import attention as att
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import mlp_apply, rmsnorm
from repro_torch.models.moe import moe_apply


#: an encoder-decoder layer entry's cross K/V: one row per batch row and
#: frame, no slots (written at prefill, read by every forward)
CROSS_KV = ("ck", "cv")


def write_slots(cur, m: int, capacity: int, device) -> torch.Tensor:
    """Slot indices (m,) for the next ``m`` tokens (ring when capacity is
    exceeded) — the slot convention ``forward_cached`` expects.  ``cur``:
    the cache's 0-dim device tensor."""
    return (cur + torch.arange(m, device=device)) % capacity


# ------------------------------------------------------------ paged KV cache


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Physical pages (P, ps, ...) -> the logical ring view (B, NB*ps, ...)."""
    B, NB = table.shape
    g = pool[table.long()]
    return g.reshape((B, NB * pool.shape[1]) + tuple(pool.shape[2:]))


def _page_index(table, slots, ps):
    pages = table[:, slots // ps].long()                    # (B, m)
    offs = (slots % ps)[None, :].expand_as(pages)
    return pages, offs


def scatter_pages(pool, table, slots, new, live=None) -> None:
    """Write ``new`` (B, m, ...) at logical ``slots`` (m,) through the page
    table, in place (masked by ``live``).  Rows whose block is unmapped land
    in the trash page — a don't-care, since their ``pos`` stays -1."""
    pages, offs = _page_index(table, slots, pool.shape[1])
    new = new.to(pool.dtype)
    if live is not None:
        new = torch.where(live, new, pool[pages, offs])
    pool[pages, offs] = new


def write_ring(t, slots, new, live=None) -> None:
    """Write ``new`` (B, m, ...) at ``slots`` (m,) of a dense (B, C, ...)
    cache tensor (K, V or ``pos``), in place; where ``live`` is false the
    old values are written back."""
    new = new.to(t.dtype)
    if live is not None:
        new = torch.where(live, new, t[:, slots])
    t[:, slots] = new


def page_native_ok(cfg: ModelConfig, m: int) -> bool:
    """True when the page-native decode attention serves this call: GQA
    entries (MLA latents keep the gather path) and decode/probe-sized query
    widths.  The SAME predicate gates the ring and the paged branches, so
    both backends pick the same implementation."""
    return cfg.mla is None and m <= 8


def _slot_views(cache, slots):
    """(read, write) closures over the K/V of logical ``slots`` of every row."""
    if "page_table" in cache:
        ps = cache["pos"].shape[1] // cache["page_table"].shape[1]
        idx = _page_index(cache["page_table"], slots, ps)
    else:
        idx = (slice(None), slots)

    def read(t):
        return t[idx].clone()

    def write(t, val):
        t[idx] = val

    return read, write


@contextlib.contextmanager
def preserved_slots(cache, slots):
    """Run a non-committing forward that writes K/V (or MLA latents) at
    ``slots``: on exit, every such slot gets its old values back.  Only a
    slot that was live (``pos >= 0``: a ring wrap, a probe or rollout past
    the capacity onto slot 0 and the prompt) needs it, but the save and
    restore run unconditionally, so no host read of ``pos`` decides them:
    writing an invisible (``pos == -1``) slot's old values back changes no
    output.  A recurrent (SSM) entry has no slots, nor has an
    encoder-decoder's cross K/V."""
    slotted = [e for e in cache["layers"] if "ssm" not in e]
    if not slotted:
        yield
        return
    read, write = _slot_views(cache, slots)
    saved = [{n: read(t) for n, t in e.items() if n not in CROSS_KV}
             for e in slotted]
    try:
        yield
    finally:
        for e, old in zip(slotted, saved):
            for n, t in old.items():
                write(e[n], t)


# ===================================================================== blocks


def _norm1(p, x, x_extra, cfg: ModelConfig):
    """``norm1`` of the block's input: ``x``, or ``concat(x, x_extra)``."""
    h_in = x if x_extra is None else torch.cat([x, x_extra], dim=-1)
    return rmsnorm(h_in, p["norm1"], cfg.norm_eps, cfg.rmsnorm_one_plus)


def attn_block_cached(p, x, positions, pos1d, cfg: ModelConfig, entry: dict,
                      kv_pos, slots, *, window: int, attn_impl: str,
                      paged: tuple | None, native: bool, paged_impl: str,
                      page_block: int, live=None, x_extra=None, enc_pos=None):
    """One cached decoder block.  New K/V are written into ``entry`` at
    ``slots`` (masked by ``live``) before the attention read.  ``paged =
    (table, ps, blocks, bpos)`` when the entry holds page pools; ``native``
    selects the page-native read (pools + compacted page list for paged
    caches, the same block algorithm over the dense ring otherwise).  An
    MLA layer writes its latents instead and reads them in the absorbed
    form (``_mla_cached``).  ``x_extra`` (the hybrid's shared block: the
    embedded stream) is concatenated to ``x`` before ``norm1``.  With
    ``enc_pos`` (an encoder-decoder's decoder block) the self-attention is
    followed by cross-attention over the entry's ``ck``/``cv``."""
    h = _norm1(p, x, x_extra, cfg)
    if cfg.mla is not None:
        x = x + _mla_cached(p["attn"], h, positions, pos1d, cfg, entry, kv_pos,
                            slots, window=window, attn_impl=attn_impl,
                            paged=paged, live=live)
        return ffn_residual(p, x, cfg)[0]
    q, k_new, v_new = att.gqa_qkv(p["attn"], h, positions, cfg)
    scale = att.attn_scale(cfg)
    if paged is not None:
        table, ps, blocks, bpos = paged
        scatter_pages(entry["k"], table, slots, k_new, live)
        scatter_pages(entry["v"], table, slots, v_new, live)
        if native:
            o = paged_ops.paged_decode_attention(
                q, entry["k"], entry["v"], blocks["pages"], blocks["count"],
                bpos, pos1d, window=window, scale=scale, impl=paged_impl,
                logical=blocks["logical"], num_blocks=table.shape[1])
        else:
            o = attention(q, gather_pages(entry["k"], table),
                          gather_pages(entry["v"], table), pos1d, kv_pos,
                          causal=True, window=window, scale=scale,
                          impl=attn_impl)
    else:
        write_ring(entry["k"], slots, k_new, live)
        write_ring(entry["v"], slots, v_new, live)
        if native:
            o = paged_ops.ring_decode_attention(
                q, entry["k"], entry["v"], pos1d, kv_pos,
                page_size=page_block, window=window, scale=scale,
                impl=paged_impl)
        else:
            o = attention(q, entry["k"], entry["v"], pos1d, kv_pos,
                          causal=True, window=window, scale=scale,
                          impl=attn_impl)
    x = x + att.gqa_out(p["attn"], o)
    if enc_pos is not None:
        x = _cross_residual(p, x, entry["ck"], entry["cv"], enc_pos, cfg,
                            attn_impl)
    return ffn_residual(p, x, cfg)[0]


def _cross_residual(p, x, ck, cv, enc_pos, cfg: ModelConfig, attn_impl: str):
    """``x + cross_attention(norm_c(x))`` against the encoder's K/V."""
    hc = rmsnorm(x, p["norm_c"], cfg.norm_eps, cfg.rmsnorm_one_plus)
    return x + att.cross_attention(p["cross"], hc, ck, cv, enc_pos, cfg,
                                   attn_impl=attn_impl)


def _mla_cached(p, h, positions, pos1d, cfg: ModelConfig, entry: dict, kv_pos,
                slots, *, window: int, attn_impl: str, paged: tuple | None,
                live):
    """MLA's attention half of a cached block: the new latents ``c`` and
    ``kr`` written at ``slots`` (masked by ``live``), then the absorbed
    attention over the ring entry or the gathered view of the pools.
    Returns y (B, m, d)."""
    q_nope, q_rope = att.mla_q(p, h, positions, cfg)
    c_new, kr_new = att.mla_latent(p, h, positions, cfg)
    if paged is not None:
        table = paged[0]
        scatter_pages(entry["c"], table, slots, c_new, live)
        scatter_pages(entry["kr"], table, slots, kr_new, live)
        cache_c = gather_pages(entry["c"], table)
        cache_kr = gather_pages(entry["kr"], table)
    else:
        write_ring(entry["c"], slots, c_new, live)
        write_ring(entry["kr"], slots, kr_new, live)
        cache_c, cache_kr = entry["c"], entry["kr"]
    return att.mla_absorbed_attend(p, q_nope, q_rope, pos1d, cfg, cache_c,
                                   cache_kr, kv_pos, window=window,
                                   attn_impl=attn_impl)


def ffn_residual(p, x, cfg: ModelConfig):
    """The block's second half: ``x + FFN(norm2(x))``, the FFN an MoE where
    the layer holds ``moe`` and its MLP otherwise.  Returns (x, the MoE's
    aux loss or None)."""
    h2 = rmsnorm(x, p["norm2"], cfg.norm_eps, cfg.rmsnorm_one_plus)
    if "moe" in p:
        f, aux = moe_apply(p["moe"], h2, cfg)
        return x + f, aux
    return x + mlp_apply(p["ffn"], h2, cfg), None


def attn_block_full(p, x, positions, pos1d, cfg: ModelConfig, *,
                    window: int = 0, x_extra=None, causal: bool = True,
                    attn_impl: str = "plain", enc_kv=None, enc_pos=None):
    """One full-sequence block (training, or the encoder): self-attention
    over the block's own keys (causal unless ``causal`` is false; by the
    plain attention unless ``attn_impl`` says otherwise, MLA in its
    expanded form and always plain), then, with ``enc_kv`` (the encoder's
    output (B, T, d)) and ``enc_pos``, cross-attention over K/V made from
    it, then the MLP or the MoE; ``x_extra`` as in ``attn_block_cached``.
    Returns (x, aux loss or None)."""
    h = _norm1(p, x, x_extra, cfg)
    if cfg.mla is not None:
        y, _ = att.mla_self_attention(p["attn"], h, positions, pos1d, cfg,
                                      window=window)
        return ffn_residual(p, x + y, cfg)
    q, k, v = att.gqa_qkv(p["attn"], h, positions, cfg)
    o = attention(q, k, v, pos1d, pos1d, causal=causal, window=window,
                  scale=att.attn_scale(cfg), impl=attn_impl)
    x = x + att.gqa_out(p["attn"], o)
    if enc_kv is not None:
        ck, cv = att.cross_attn_kv(p["cross"], enc_kv, cfg)
        x = _cross_residual(p, x, ck, cv, enc_pos, cfg, attn_impl)
    return ffn_residual(p, x, cfg)


def ssm_block_full(p, x, cfg: ModelConfig, *, valid=None, state=None,
                   scan_impl: str = "auto"):
    h = rmsnorm(x, p["norm"], cfg.norm_eps, cfg.rmsnorm_one_plus)
    y, new_state = ssm_mod.ssm_forward(
        p["ssm"], h, cfg, valid=valid,
        conv_tail=None if state is None else state["conv"],
        h0=None if state is None else state["ssm"], scan_impl=scan_impl)
    return x + y, new_state


def ssm_block_step(p, x, cfg: ModelConfig, state):
    h = rmsnorm(x, p["norm"], cfg.norm_eps, cfg.rmsnorm_one_plus)
    y, new_state = ssm_mod.ssm_step(p["ssm"], h, cfg, state)
    return x + y, new_state


def forward_train(layers, final_norm, x, positions, pos1d, cfg: ModelConfig, *,
                  valid=None, remat: bool = True, window: int = 0, shared=None,
                  enc_out=None, enc_pos=None):
    """Full-sequence forward over the stack, no cache (training).  Returns
    (the final-normed hidden states, the MoE layers' aux losses summed in
    layer order, 0-dim float32: 0 without MoE layers).  ``remat``
    recomputes each block in the backward pass (``torch.utils.checkpoint``,
    the reference's ``jax.checkpoint`` around its scan body): only the
    blocks' inputs are kept.  ``shared``: a hybrid's shared block.  An
    encoder-decoder's decoder needs ``enc_out`` (the encoder's output (B,
    T, d), ``encode``) and ``enc_pos`` (B, T): each block cross-attends to
    K/V made from it in the call."""
    if cfg.arch_type not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
        raise ValueError(f"the port trains dense, vlm, moe, ssm, hybrid and encdec "
                         f"models, not {cfg.arch_type!r}")
    if (cfg.arch_type == "encdec") != (enc_out is not None):
        raise ValueError(f"{cfg.name}: enc_out goes with an encoder-decoder, and an "
                         f"encoder-decoder needs it")

    def body(kind, p, xx, extra, enc):
        if kind == "ssm":
            return ssm_block_full(p, xx, cfg, valid=valid, scan_impl="plain")[0], None
        return attn_block_full(p, xx, positions, pos1d, cfg, window=window,
                               x_extra=extra, enc_kv=enc, enc_pos=enc_pos)

    emb0 = x
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    own = iter(layers)
    for kind in cfg.block_kinds():
        p, extra = (shared, emb0) if kind == "shared_attn" else (next(own), None)
        x, aux = (checkpoint(body, kind, p, x, extra, enc_out, use_reentrant=False)
                  if remat else body(kind, p, x, extra, enc_out))
        if aux is not None:
            aux_total = aux_total + aux
    return rmsnorm(x, final_norm, cfg.norm_eps, cfg.rmsnorm_one_plus), aux_total


def encode(enc_layers, enc_norm, frames, enc_pos, cfg: ModelConfig, *,
           attn_impl: str = "auto", remat: bool = False) -> torch.Tensor:
    """The encoder-decoder's bidirectional encoder over the stub frontend
    frames (B, T, d): each block's self-attention not causal, its positions
    (RoPE included) ``enc_pos`` (B, T), then ``enc_norm``.  ``remat``
    recomputes each block in the backward pass, as ``forward_train``."""
    def body(p, xx):
        return attn_block_full(p, xx, enc_pos, enc_pos, cfg, causal=False,
                               attn_impl=attn_impl)[0]

    x = frames
    for p in enc_layers:
        x = checkpoint(body, p, x, use_reentrant=False) if remat else body(p, x)
    return rmsnorm(x, enc_norm, cfg.norm_eps, cfg.rmsnorm_one_plus)


def forward_cached(layers, final_norm, x, positions, pos1d, slots, cache,
                   cfg: ModelConfig, *, commit: bool = True,
                   advance: int | None = None,
                   attn_impl: str = "auto", window: int = 0,
                   paged_impl: str = "gather", page_block: int = 16,
                   scan_impl: str = "auto", live=None, shared=None):
    """Unified prefill (m = S) / decode / probe forward against a cache.

    Returns the final-normed hidden states (B, m, d).  With ``commit`` the
    cache's ``pos`` and ``cur`` advance over the new tokens; without it they
    are left as they were (the K/V writes still land in ``slots`` — wrap
    them in ``preserved_slots``; SSM states are not written at all).  A
    committing forward writes the positions of all m slots and advances
    ``cur`` by ``advance`` (m by default; 1 for the fused decode-and-probe
    step, which a recurrent stack does not take: its states hold no
    slots).  A
    committing forward masked by ``live`` (0-dim bool) writes its slots and
    advances ``cur`` only where ``live`` is true; an SSM block's new state
    is still committed (the caller's ``freeze_inactive_rows`` takes it
    back).  SSM blocks run the chunked scan for prefill-sized calls (m >
    16, invalid (pos -1) steps masked) and recur step by step, unmasked,
    for decode and probe calls, as in the reference; a committing call
    replaces the block's state entry with the new state.  ``shared``: a
    hybrid's shared block, run at every ``shared_attn`` position on
    ``concat(x, emb0)``.  An encoder-decoder's blocks read the cross K/V
    of their entries at ``cache["enc_pos"]`` and never write them."""
    m = x.shape[1]
    kinds = cfg.block_kinds()
    kv_pos = cache["pos"] if commit else cache["pos"].clone()
    write_ring(kv_pos, slots, pos1d, live)
    native = paged_impl != "gather" and page_native_ok(cfg, m)
    paged = None
    if "page_table" in cache:
        table = cache["page_table"]
        ps = cache["pos"].shape[1] // table.shape[1]
        blocks = cache.get("blocks")
        bpos = None
        if native:
            if blocks is None:
                # a silent gather here would split the per-impl paged == ring
                # pairing (the ring side WOULD run the block algorithm)
                raise ValueError(
                    f"paged_impl={paged_impl!r} needs the compacted page "
                    f"list (cache['blocks'], serving.cache.blocks_arrays): "
                    f"take the cache from the serving executor's "
                    f"paged_cache_for(..., native=True)")
            bpos = paged_ops.block_positions(kv_pos, blocks["pages"],
                                             blocks["logical"], ps)
        paged = (table, ps, blocks, bpos)
    use_full = m > 16
    valid = pos1d >= 0
    emb0 = x
    entries = cache["layers"]
    own = iter(layers)
    for i, kind in enumerate(kinds):
        if kind == "ssm":
            p = next(own)
            if use_full:
                x, new = ssm_block_full(p, x, cfg, valid=valid, state=entries[i],
                                        scan_impl=scan_impl)
            else:
                x, new = ssm_block_step(p, x, cfg, entries[i])
            if commit:
                entries[i] = new
            continue
        p, extra = (shared, emb0) if kind == "shared_attn" else (next(own), None)
        x = attn_block_cached(
            p, x, positions, pos1d, cfg, entries[i], kv_pos, slots, window=window,
            attn_impl=attn_impl, paged=paged, native=native,
            paged_impl=paged_impl, page_block=page_block, live=live,
            x_extra=extra, enc_pos=cache.get("enc_pos"))
    if commit:
        _advance_cur(cache, m if advance is None else advance, live)
    return rmsnorm(x, final_norm, cfg.norm_eps, cfg.rmsnorm_one_plus)


def _advance_cur(cache, m: int, live) -> None:
    """``cur`` += m, or m × ``live`` for a masked forward."""
    if live is None:
        cache["cur"].add_(m)
    else:
        cache["cur"].add_(live.long(), alpha=m)
