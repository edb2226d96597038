"""Decode-state allocation: the ring KV cache and the block-paged variant
for the GQA and MLA decoders, the recurrent state of a Mamba2 stack, both
for a Zamba2-style hybrid, and the cross K/V of an encoder-decoder (port of
``repro/serving/cache.py``).

Layout (consumed by ``models.transformer.forward_cached``)::

    cache = {"layers": [{"k", "v"} per layer]
                     | [{"c", "kr"} per layer],                     # cfg.mla
                     | [{"ssm", "conv": {"x", "bc"}} per layer],   # arch "ssm"
                     | one of the two per block, in block order,   # arch
                       an SSM state per SSM block and K/V per      # "hybrid"
                       application of the shared block
                     | [{"k", "v", "ck", "cv"} per decoder layer], # "encdec"
             "pos": (B, C) int32 — absolute position held in each slot, -1 = empty,
             "cur": 0-dim int64 on the cache's device — committed length
                    (the shared ring pointer; the host keeps a mirror of it
                    from each chunk's snapshot, never reads it mid-chunk),
             ["enc_pos": (B, T) int32 — encoder frame positions (encdec)]}

SSM: ``ssm`` is the (B, nh, N, hp) float32 scan state, ``conv`` the
(B, w-1, ·) causal-conv tails; there is no capacity axis, so no paged
variant of an SSM stack; a hybrid's paged cache pools its attention
entries and keeps its SSM states per row.  Ring: each layer's ``k``/``v`` is (B, C, Hkv, hd); an MLA
layer's latent ``c`` (B, C, kv_lora) and rope key ``kr`` (B, C, rope_d).
Paged: the same logical addressing, but each slot tensor is a page POOL
(num_pages, page_size, ...) shared by all rows, plus a ``page_table`` (B,
NB) int32 mapping each row's logical block ``slot // page_size`` to a
physical page (an encoder-decoder's cross K/V ``ck``/``cv``, (B, T, Hkv,
hd), and ``enc_pos`` have no capacity axis and stay dense, per row);
page 0 is the trash page whose every read is position-masked.  Page-native reads additionally
carry the compacted mapped-page list ``blocks`` (``blocks_arrays``).

Where the reference returns new caches, these functions update the cache
they are given in place (the reference donated it) and return it.  The
serving executor keeps the caches it allocates across serves
(``reset_cache`` empties one in place), so a chunk graph captured over
their tensors replays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype, upload
from repro_torch.models.ssm import ssm_state_init
from repro_torch.models.transformer import CROSS_KV

#: physical page id reserved as the trash page — never handed out by the
#: allocator; unmapped page-table entries point here
PAGE_TRASH = 0

ATTN_IMPLS = ("gather", "auto", "plain", "cuda")


def page_align(n_slots: int, page_size: int) -> int:
    """Round a slot count up to a whole number of pages."""
    return -(-n_slots // page_size) * page_size


@dataclasses.dataclass
class CacheConfig:
    """KV-cache backend for the serving stack.

    ``kind="ring"``: a dense ring of ``capacity`` logical slots per row.
    ``kind="paged"``: the same logical addressing backed by a pool of
    ``num_pages`` pages of ``page_size`` slots (0 = ring-equivalent auto
    sizing).  ``attn_impl`` is the decode/probe attention: ``gather``
    materialises the paged cache's logical view; ``auto``/``cuda``/``plain``
    read K/V straight off the pools through the compacted page list (the
    ring runs the same block algorithm, keeping paged == ring bit-exact per
    impl).
    """

    kind: str = "ring"
    page_size: int = 16
    num_pages: int = 0
    attn_impl: str = "gather"

    def __post_init__(self):
        if self.kind not in ("ring", "paged"):
            raise ValueError(f"CacheConfig.kind must be 'ring' or 'paged', "
                             f"got {self.kind!r}")
        if self.page_size < 1:
            raise ValueError("CacheConfig.page_size must be >= 1")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"CacheConfig.attn_impl must be one of "
                             f"{'/'.join(ATTN_IMPLS)}, got {self.attn_impl!r}")


def _attn_entry(cfg: ModelConfig, lead: tuple, dtype, device) -> dict:
    """One attention layer's slot tensors, ``lead`` = (B, C) or (num_pages,
    page_size): K and V (..., Hkv, hd), or MLA's latent ``c`` (...,
    kv_lora) and shared rope key ``kr`` (..., rope_d)."""
    if cfg.mla is not None:
        tails = {"c": (cfg.mla.kv_lora_rank,), "kr": (cfg.mla.qk_rope_head_dim,)}
    else:
        kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
        tails = {"k": kv, "v": kv}
    return {n: torch.zeros(lead + t, dtype=dtype, device=device)
            for n, t in tails.items()}


def _cur(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def _entries(cfg: ModelConfig, batch: int, lead: tuple, dtype, device) -> list:
    """One entry per block: a zero recurrent state (B rows) for an SSM
    block, an attention entry of slot tensors ``lead + ...`` otherwise (an
    encoder-decoder's with its cross K/V, ``batch`` rows of
    ``encoder_len`` frames)."""
    out = []
    for kind in cfg.block_kinds():
        if kind == "ssm":
            out.append(ssm_state_init(cfg, batch, dtype, device))
            continue
        entry = _attn_entry(cfg, lead, dtype, device)
        if cfg.arch_type == "encdec":
            cross = (batch, cfg.encoder_len, cfg.n_kv_heads, cfg.resolved_head_dim)
            for name in CROSS_KV:
                entry[name] = torch.zeros(cross, dtype=dtype, device=device)
        out.append(entry)
    return out


def _with_enc_pos(cfg: ModelConfig, cache: dict, batch: int, device) -> dict:
    """An encoder-decoder cache's ``enc_pos`` (B, T) int32 (zeros until a
    prefill writes the frames' positions)."""
    if cfg.arch_type == "encdec":
        cache["enc_pos"] = torch.zeros((batch, cfg.encoder_len),
                                       dtype=torch.int32, device=device)
    return cache


def is_recurrent(entry: dict) -> bool:
    """An SSM block's entry: per-row state, no slots."""
    return "ssm" in entry


def alloc_cache(cfg: ModelConfig, batch: int, capacity: int, *, device,
                dtype=None) -> dict:
    """An empty ring cache with ``capacity`` kv slots per sequence (a zero
    recurrent state for each SSM block)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    return _with_enc_pos(cfg, {
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
        "cur": _cur(device),
        "layers": _entries(cfg, batch, (batch, capacity), dtype, device),
    }, batch, device)


def blocks_arrays(pages, logical, counts, *, device) -> dict:
    """Device form of the allocator's compacted mapped-page list: pages /
    logical (B, NBK) int32 (trash/0-padded past ``counts``), counts (B,)."""
    def t(x):
        return upload(np.asarray(x, np.int32), device)

    return {"pages": t(pages), "logical": t(logical), "count": t(counts)}


def alloc_paged_cache(cfg: ModelConfig, batch: int, capacity: int,
                      page_size: int, num_pages: int, *, device,
                      dtype=None) -> dict:
    """An empty block-paged cache: ``capacity`` LOGICAL slots per row (a
    page multiple), ``num_pages`` physical pages shared by all rows, the
    page table all-trash; a hybrid's SSM states stay per row.  The
    page-native read also needs ``blocks`` (``blocks_arrays``; the serving
    executor puts them in)."""
    dtype = dtype or torch_dtype(cfg.dtype)
    if cfg.arch_type == "ssm":
        raise ValueError("arch 'ssm' has no KV capacity axis to page — use "
                         "the ring cache (its state is O(1) per row already)")
    if capacity % page_size:
        raise ValueError(f"paged capacity {capacity} must be a multiple of "
                         f"page_size {page_size}")
    if num_pages < 2:
        raise ValueError("num_pages must be >= 2 (page 0 is the trash page)")
    NB = capacity // page_size
    cache = {
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32, device=device),
        "cur": _cur(device),
        "page_table": torch.full((batch, NB), PAGE_TRASH, dtype=torch.int32,
                                 device=device),
        "layers": _entries(cfg, batch, (num_pages, page_size), dtype, device),
    }
    return _with_enc_pos(cfg, cache, batch, device)


def pack_paged_cache(paged: dict, dense: dict, table) -> dict:
    """Scatter a freshly prefilled DENSE cache (capacity C_pre, a page
    multiple) into the empty paged cache ``paged`` through ``table`` (the
    allocator's (B, NB) table with the prompt blocks mapped).  Blocks of
    ``dense`` past a row's mapped prompt land in the trash page; SSM
    states, cross K/V and ``enc_pos`` copy whole."""
    dev = paged["pos"].device
    table = upload(np.asarray(table, np.int32), dev)
    NB = table.shape[1]
    ps = paged["pos"].shape[1] // NB
    C_pre = dense["pos"].shape[1]
    nbp = C_pre // ps
    paged["page_table"].copy_(table)
    paged["pos"][:, :C_pre] = dense["pos"]
    paged["cur"].copy_(dense["cur"])
    if "enc_pos" in dense:
        paged["enc_pos"].copy_(dense["enc_pos"])
    idx = table[:, :nbp].long()
    for pe, de in zip(paged["layers"], dense["layers"]):
        if is_recurrent(de):
            for p, d in zip(_leaves(pe), _leaves(de)):
                p.copy_(d)
            continue
        for name, src in de.items():
            if name in CROSS_KV:
                pe[name].copy_(src)
                continue
            B = src.shape[0]
            pe[name][idx] = src.reshape((B, nbp, ps) + tuple(src.shape[2:])).to(
                pe[name].dtype)
    return paged


def merge_paged_row(cache: dict, one: dict, row: int, row_table) -> dict:
    """Paged slot admission: write the single-sequence DENSE cache ``one``
    (batch 1, prefill capacity C_pre) into batch row ``row`` through
    ``row_table`` (the allocator's fresh mapping for the row).  The row's
    ``pos`` is replaced (tail -1), its SSM states, cross K/V and
    ``enc_pos`` too, and ``cur`` becomes ``max(cur, one_cur)`` — the ring's
    semantics, so the admitted stream matches the ring's."""
    dev = cache["pos"].device
    row_table = upload(np.asarray(row_table, np.int32), dev)
    C = cache["pos"].shape[1]
    ps = C // cache["page_table"].shape[1]
    C_pre = one["pos"].shape[1]
    nbp = C_pre // ps
    cache["page_table"][row] = row_table
    row_pos = torch.full((C,), -1, dtype=torch.int32, device=dev)
    row_pos[:C_pre] = one["pos"][0]
    cache["pos"][row] = row_pos
    torch.maximum(cache["cur"], one["cur"], out=cache["cur"])
    if "enc_pos" in one:
        cache["enc_pos"][row] = one["enc_pos"][0]
    idx = row_table[:nbp].long()
    for pe, oe in zip(cache["layers"], one["layers"]):
        if is_recurrent(oe):
            for c, o in zip(_leaves(pe), _leaves(oe)):
                c[row] = o[0]
            continue
        for name, t in oe.items():
            src = t[0]
            if name in CROSS_KV:
                pe[name][row] = src
                continue
            pe[name][idx] = src.reshape((nbp, ps) + tuple(src.shape[1:])).to(
                pe[name].dtype)
    return cache


def _leaves(entry: dict):
    """The tensors of a layer entry, nested dicts flattened in key order."""
    for _, v in sorted(entry.items()):
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def cache_leaves(cache: dict) -> list:
    """Every tensor of a cache (``pos``, ``cur``, the page table and page
    list, ``enc_pos``, every layer's K/V, cross K/V or states), in a fixed
    order."""
    out = list(_leaves({k: v for k, v in cache.items() if k != "layers"}))
    for e in cache["layers"]:
        out.extend(_leaves(e))
    return out


def reset_cache(cache: dict) -> dict:
    """Empty ``cache`` in place: every slot empty (``pos`` -1), ``cur`` 0,
    the page table all-trash, recurrent states and ``enc_pos`` zero.  K/V,
    MLA latents and cross K/V stay as they are: a slot with ``pos`` -1 is
    masked out of every read, and a prefill writes the cross K/V whole."""
    cache["pos"].fill_(-1)
    cache["cur"].zero_()
    if "enc_pos" in cache:
        cache["enc_pos"].zero_()
    if "page_table" in cache:
        cache["page_table"].fill_(PAGE_TRASH)
    for e in cache["layers"]:
        if is_recurrent(e):
            for t in _leaves(e):
                t.zero_()
    return cache


def commit_layers(cache: dict, kept: list) -> dict:
    """Copy the SSM entries of ``cache`` (new state tensors, which a commit
    or ``freeze_inactive_rows`` put there) into the entries ``kept`` (those
    it held before), and put those back: the recurrent state is then the
    same tensors as before, updated in place.  Attention entries are
    written in place and never replaced: nothing of them is copied."""
    for new, old in zip(cache["layers"], kept):
        if not is_recurrent(old):
            continue
        for n, o in zip(_leaves(new), _leaves(old)):
            if n is not o:
                o.copy_(n)
    cache["layers"] = list(kept)
    return cache


def merge_cache_row(cache: dict, one: dict, row: int) -> dict:
    """Ring slot admission: replace batch row ``row`` wholesale (K/V slots,
    positions, SSM states, cross K/V and ``enc_pos``) with the
    single-sequence cache ``one`` (batch 1, same capacity); the shared ring
    pointer advances to ``max(cur, one_cur)``."""
    cache["pos"][row] = one["pos"][0]
    if "enc_pos" in one:
        cache["enc_pos"][row] = one["enc_pos"][0]
    torch.maximum(cache["cur"], one["cur"], out=cache["cur"])
    for ce, oe in zip(cache["layers"], one["layers"]):
        for c, o in zip(_leaves(ce), _leaves(oe)):
            c[row] = o[0]
    return cache


def _freeze(new, old, active):
    if isinstance(new, dict):
        return {k: _freeze(v, old[k], active) for k, v in new.items()}
    mask = active.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(mask, new, old)


def freeze_inactive_rows(cache: dict, old_layers: list, active) -> dict:
    """Roll back the recurrent state of rows with ``active`` False to
    ``old_layers`` (the layer entries before the step).

    K/V are slot-addressed and masked by position, so an inactive row's
    write is made invisible by ``pos = -1``; an SSM state is cumulative, and
    stepping it with a PAD token would pollute the row for a later forced
    answer.  Only SSM entries are frozen (the reference's leaves ``ssm``,
    ``x`` and ``bc``): a hybrid's attention entries, whose page pools have
    no row axis, pass through.  The new state tensors are replaced, not
    written, so ``old_layers`` may hold tensors the caller still reads."""
    cache["layers"] = [_freeze(n, o, active) if is_recurrent(n) else n
                       for n, o in zip(cache["layers"], old_layers)]
    return cache
