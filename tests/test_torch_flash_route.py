"""Which flash kernel the port launches: ``flash_variant``'s rule, on the CPU.

bf16 at an instantiated (Dk, Dv) pair takes the tensor-core kernel
(``"mma"``); bf16 at MLA's absorbed pairs (kv_lora + rope, kv_lora) takes
the MLA kernel (``"mla"``); bf16 at Gemma's (256, 256) the wide kernel
(``"wide"``); float32, whose tensor-core products would be TF32, and bf16
head dims outside the three sets take the scalar kernel.  The wide
kernel's instantiated pairs and an emulation of its 32-key tiles (held to
the plain version at the bf16 bar, blind to trailing masked slots).  The
MLA kernel's key splits (``mla_splits``), the constants shared with its
source, and an emulation of its tiles, splits and merge in float32 (held
to the plain version at the bf16 bar, and unchanged bit for bit by
trailing empty splits).  ``mla_absorbed_attend`` hands v as the view of
k's first r columns: on the plain path that equals handing the latent
itself, bit for bit.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``tests/test_torch_mla_cuda.py``, marker
``gpu``; ``tests/test_torch_flash_wide_cuda.py`` for the wide kernel).
"""
import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import attention as att

CU = Path(fa.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
ATTENTION_CONFIGS = sorted(n for n, c in REGISTRY.items() if c.arch_type != "ssm")


@pytest.mark.parametrize("name", ATTENTION_CONFIGS)
def test_every_attention_config_routes_by_its_dtype(name):
    cfg = REGISTRY[name]
    hd = cfg.resolved_head_dim
    want = ("scalar" if cfg.dtype != "bfloat16" else "wide" if hd == 256
            else "mma")
    assert fa.flash_variant(cfg.dtype, hd, hd) == want


def test_the_served_bf16_configs_take_the_tensor_cores():
    for name, want in (("eat-paper-8b", "mma"), ("qwen3-1.7b", "mma"),
                       ("codeqwen1.5-7b", "mma"), ("gemma-2b", "wide"),
                       ("gemma-7b", "wide"), ("zamba2-2.7b", "mma")):
        cfg = get_config(name)
        assert cfg.dtype == "bfloat16"
        hd = cfg.resolved_head_dim
        assert fa.flash_variant(cfg.dtype, hd, hd) == want
    for name in ("tiny", "tiny-proxy", "tiny-reasoner"):
        cfg = get_config(name)
        assert fa.flash_variant(cfg.dtype, cfg.resolved_head_dim,
                                cfg.resolved_head_dim) == "scalar"


@pytest.mark.parametrize("dtype,dk,dv,want", [
    (torch.bfloat16, 80, 80, "mma"),          # zamba2-2.7b's shared block
    (torch.bfloat16, 80, 64, "scalar"),       # outside the instantiated set
    (torch.bfloat16, 256, 256, "wide"),       # gemma-2b, gemma-7b
    ("bfloat16", 256, 256, "wide"),
    (torch.float32, 256, 256, "scalar"),      # TF32 would miss the f32 bar
    (torch.float16, 256, 256, "scalar"),
    (torch.bfloat16, 256, 128, "scalar"),
    (torch.bfloat16, 128, 256, "scalar"),
    (torch.bfloat16, 512, 512, "scalar"),
    (torch.bfloat16, 64, 96, "scalar"),       # (96, 64) is, (64, 96) is not
    (torch.float32, 128, 128, "scalar"),      # TF32 would miss the f32 bar
    (torch.float16, 128, 128, "scalar"),
    (torch.bfloat16, 128, 128, "mma"),
    (torch.bfloat16, 96, 64, "mma"),
    ("bfloat16", 16, 16, "mma"),
    ("float32", 16, 16, "scalar"),
    (torch.bfloat16, 576, 512, "mla"),        # deepseek-v2-236b, absorbed
    (torch.bfloat16, 48, 32, "mla"),          # its reduced() variant
    ("bfloat16", 576, 512, "mla"),
    (torch.float32, 576, 512, "scalar"),      # TF32 would miss the f32 bar
    (torch.float32, 48, 32, "scalar"),
    (torch.bfloat16, 192, 128, "scalar"),     # MLA's expanded training shape
    (torch.bfloat16, 512, 576, "scalar"),
    (torch.bfloat16, 576, 576, "scalar"),
    (torch.float16, 576, 512, "scalar"),
])
def test_flash_variant_boundaries(dtype, dk, dv, want):
    assert fa.flash_variant(dtype, dk, dv) == want


def test_instantiated_pairs_match_the_source():
    """The C entry point instantiates exactly the pairs the rule routes to
    it, each a multiple of 16 up to 128."""
    pairs = {(int(a), int(b)) for a, b in
             re.findall(r"^\s*REPRO_MMA_CASE\((\d+), (\d+)\)", CU.read_text(), re.M)}
    assert pairs == set(fa.MMA_HEAD_DIMS)
    assert all(d % 16 == 0 and 16 <= d <= 128 for pair in pairs for d in pair)


def test_mla_instantiated_pairs_and_constants_match_the_source():
    """The MLA entry point instantiates exactly ``MLA_HEAD_DIMS``; its rows
    per block and keys per split are the wrapper's."""
    src = CU.read_text()
    pairs = {(int(a), int(b)) for a, b in
             re.findall(r"^\s*REPRO_MLA_CASE\((\d+), (\d+)\)", src, re.M)}
    assert pairs == set(fa.MLA_HEAD_DIMS)
    assert not pairs & set(fa.MMA_HEAD_DIMS)
    assert all(dk % 16 == 0 and dv % 32 == 0 and dv < dk for dk, dv in pairs)
    consts = dict(re.findall(r"constexpr int (MLA_\w+) = (\d+);", src))
    assert int(consts["MLA_BM"]) == fa.MLA_ROWS
    assert int(consts["MLA_SPLIT_KEYS"]) == fa.MLA_SPLIT_KEYS
    assert fa.MLA_SPLIT_KEYS % int(consts["MLA_BN"]) == 0


def test_mla_configs_route_their_absorbed_pair_to_the_mla_kernel():
    """The absorbed pair of deepseek-v2-236b and of its bf16 reduced variant
    takes the MLA kernel; float32 and the full model's expanded training
    pair (192, 128) the scalar one.  (The reduced variant's expanded pair,
    32 + 16 and 32, is its absorbed pair; training runs the plain attention
    at both widths.)"""
    full = get_config("deepseek-v2-236b")
    for cfg in (full, dataclasses.replace(full.reduced(), dtype="bfloat16")):
        m = cfg.mla
        dk, dv = m.kv_lora_rank + m.qk_rope_head_dim, m.kv_lora_rank
        assert cfg.dtype == "bfloat16" and fa.flash_variant(cfg.dtype, dk, dv) == "mla"
        assert fa.flash_variant("float32", dk, dv) == "scalar"
    m = full.mla
    assert fa.flash_variant(full.dtype, m.qk_nope_head_dim + m.qk_rope_head_dim,
                            m.v_head_dim) == "scalar"


@pytest.mark.parametrize("B,Sq,Hq,Hkv,Skv,want", [
    (4, 1, 128, 1, 704, 11),      # the serve's decode: 8 row tiles
    (4, 1, 128, 1, 705, 12),
    (4, 2, 128, 1, 64, 1),        # a probe
    (4, 16, 128, 1, 704, 11),     # 128 row tiles: still under 132
    (4, 17, 128, 1, 704, 0),      # 136 row tiles
    (4, 512, 128, 1, 512, 0),     # the cohort prefill
    (1, 66, 128, 1, 66, 0),       # 132 row tiles
    (1, 65, 128, 1, 66, 2),
    (2, 500, 4, 1, 520, 9),       # reduced: 32 row tiles
    (2, 500, 20, 1, 520, 0),      # reduced, g = 20: 314 row tiles
])
def test_mla_splits_rule(B, Sq, Hq, Hkv, Skv, want):
    assert fa.mla_splits(B, Sq, Hq, Hkv, Skv) == want


@pytest.mark.parametrize("B,Sq,Hq", [(4, 1, 128), (2, 7, 40), (1, 600, 4)])
def test_mla_split_decision_ignores_the_key_count(B, Sq, Hq):
    """Whether to split is a rule of B, Sq and the heads: only the number of
    splits grows with the keys, one per MLA_SPLIT_KEYS."""
    counts = [fa.mla_splits(B, Sq, Hq, 1, skv) for skv in range(1, 2000, 37)]
    assert all(c == 0 for c in counts) or all(
        c == -(-skv // fa.MLA_SPLIT_KEYS) for c, skv in zip(counts, range(1, 2000, 37)))


def _emulate_mla(q, k, Dv, q_pos, kv_pos, *, n_split, scale, window=0):
    """The MLA kernel's arithmetic in float32 on the CPU: rows = (query
    position, head) pairs of the one kv head, 32-key tiles aligned at key 0
    with an online softmax (p rounded to bf16 for P V, as the kernel rounds
    it), over every key or per split of MLA_SPLIT_KEYS keys, the splits
    folded in increasing order against their largest max."""
    B, Sq, Hq, Dk = q.shape
    Skv = k.shape[1]
    qs = (q * torch.full((), scale, dtype=q.dtype)).float().reshape(B, Sq * Hq, Dk)
    kf = k[:, :, 0].float()
    qp = q_pos.repeat_interleave(Hq, dim=1)[:, :, None]
    spans = ([(s, min(Skv, s + fa.MLA_SPLIT_KEYS))
              for s in range(0, n_split * fa.MLA_SPLIT_KEYS, fa.MLA_SPLIT_KEYS)]
             if n_split else [(0, Skv)])
    parts = []
    for lo, hi in spans:
        m = torch.full((B, Sq * Hq), -1e30)
        l = torch.zeros((B, Sq * Hq))
        acc = torch.zeros((B, Sq * Hq, Dv))
        for t0 in range(lo, hi, 32):
            kb, kp = kf[:, t0:min(hi, t0 + 32)], kv_pos[:, None, t0:min(hi, t0 + 32)]
            valid = (kp >= 0) & (kp <= qp)
            if window:
                valid = valid & (qp - kp < window)
            s = torch.where(valid, torch.einsum("brd,bkd->brk", qs, kb), -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("brk,bkd->brd", p.bfloat16().float(), kb[..., :Dv])
            acc, m = acc * alpha[..., None] + pv, m_new
        parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    l_tot, a_tot = torch.zeros_like(M), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        l_tot, a_tot = l_tot + w * l, a_tot + w[..., None] * acc
    out = torch.where(l_tot[..., None] > 0, a_tot / l_tot.clamp_min(1e-30)[..., None], 0.0)
    return out.reshape(B, Sq, Hq, Dv).bfloat16()


def _mla_inputs(B, Sq, Hq, C, extra=0, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, 48)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(B, C, 1, 48)), dtype=torch.float32)
    k = torch.cat([k, torch.as_tensor(rng.normal(size=(B, extra, 1, 48)),
                                      dtype=torch.float32)], 1)
    ar = torch.arange(C, dtype=torch.int32)[None]
    n = C - 7 * torch.arange(B, dtype=torch.int32)[:, None]
    kv_pos = torch.where(ar < n, ar, -1)
    kv_pos = torch.cat([kv_pos, torch.full((B, extra), -1, dtype=torch.int32)], 1)
    q_pos = (n - Sq + ar[:, :Sq]).to(torch.int32)
    return q.bfloat16(), k.bfloat16(), q_pos, kv_pos.to(torch.int32)


@pytest.mark.parametrize("B,Sq,Hq,C,window", [(2, 1, 4, 150, 0), (2, 9, 20, 100, 0),
                                              (3, 40, 4, 70, 12), (2, 40, 4, 40, 0)])
def test_mla_emulation_within_the_bar_and_blind_to_empty_splits(B, Sq, Hq, C, window):
    """The kernel's tiling, split and merge, emulated at the reduced pair
    (48, 32), split or not: within chip_smoke.py's bf16 bar of the plain
    version (one ulp + 2^-7 x the attention of |v|), and bitwise the same
    with two whole splits of empty slots appended."""
    scale = 1.0 / math.sqrt(48)
    q, k, q_pos, kv_pos = _mla_inputs(B, Sq, Hq, C)
    v = k[..., :32]
    ref = fa.attention_plain(q, k, v, q_pos, kv_pos, window=window, scale=scale)
    spread = fa.attention_plain(q, k, v.abs(), q_pos, kv_pos, window=window,
                                scale=scale).float()
    for n_split in (0, -(-C // fa.MLA_SPLIT_KEYS)):
        out = _emulate_mla(q, k, 32, q_pos, kv_pos, n_split=n_split, scale=scale,
                           window=window)
        big = torch.maximum(out.float().abs(), ref.float().abs())
        ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
        assert ((out.float() - ref.float()).abs() <= ulp + 2.0 ** -7 * spread).all()
        extra = 2 * fa.MLA_SPLIT_KEYS
        ql, kl, qpl, kpl = _mla_inputs(B, Sq, Hq, C, extra=extra)
        longer = _emulate_mla(ql, kl, 32, qpl, kpl, scale=scale, window=window,
                              n_split=n_split + 2 if n_split else 0)
        assert torch.equal(out, longer)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_absorbed_v_view_equals_the_latent_on_the_plain_path(dtype):
    """``mla_absorbed_attend`` hands v as ``k_cat[..., :r]``: the plain
    attention's output is bitwise the one with v = the latent cache itself."""
    rng = np.random.default_rng(1)
    B, m, H, C, r, rope = 2, 3, 4, 150, 32, 16

    def rnd(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32).to(dtype)

    q, c, kr = rnd(B, m, H, r + rope), rnd(B, C, r), rnd(B, C, rope)
    k = torch.cat([c, kr], dim=-1)[:, :, None, :]
    ar = torch.arange(C, dtype=torch.int32)[None].expand(B, C).contiguous()
    q_pos = ar[:, C - m:].contiguous()
    kw = dict(scale=0.125, impl="plain")
    view = fa.attention(q, k, k[..., :r], q_pos, ar, **kw)
    latent = fa.attention(q, k, c[:, :, None, :], q_pos, ar, **kw)
    assert not k[..., :r].is_contiguous() and fa.is_k_prefix(k[..., :r], k)
    assert not fa.is_k_prefix(c[:, :, None, :], k)
    assert torch.equal(view, latent)


def test_mla_absorbed_attend_hands_the_view_of_k(monkeypatch):
    """The cached MLA forward calls flash with v = k[..., :kv_lora]: the
    view the MLA kernel takes (it reads V out of K's tile)."""
    cfg = get_config("deepseek-v2-236b").reduced()
    seen = {}

    def spy(q, k, v, *a, **kw):
        seen["prefix"] = fa.is_k_prefix(v, k)
        seen["dims"] = (k.shape[-1], v.shape[-1])
        return fa.attention_plain(q, k, v, *a, **{x: kw[x] for x in ("causal", "window",
                                                                     "scale")})

    monkeypatch.setattr(att, "attention", spy)
    m = cfg.mla
    g = torch.Generator().manual_seed(0)
    p = att.mla_init(g, cfg, torch.float32, "cpu")
    x = torch.randn((1, 5, cfg.d_model), generator=g)
    pos = torch.arange(5, dtype=torch.int32)[None]
    q_nope, q_rope = att.mla_q(p, x, pos, cfg)
    c, kr = att.mla_latent(p, x, pos, cfg)
    att.mla_absorbed_attend(p, q_nope, q_rope, pos, cfg, c, kr, pos)
    assert seen == {"prefix": True, "dims": (m.kv_lora_rank + m.qk_rope_head_dim,
                                             m.kv_lora_rank)}


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.normal(size=(1, 8, 4, 128)), dtype=torch.bfloat16)
    k = torch.as_tensor(rng.normal(size=(1, 8, 2, 128)), dtype=torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32)[None]
    before = (fa.flash_attention_cuda.launches,
              dict(fa.flash_attention_cuda.variant_launches))
    out = fa.attention(q, k, k, pos, pos)
    torch.testing.assert_close(out, fa.attention_plain(q, k, k, pos, pos,
                                                       scale=128 ** -0.5),
                               atol=0, rtol=0)
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_cuda.variant_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.attention(q, k, k, pos, pos, impl="cuda")


@pytest.mark.parametrize("variant", ["mma", "wide", "mla", "tensor"])
def test_only_the_scalar_kernel_may_be_forced(variant):
    """A forced tensor-core variant is refused before any launch: a pair
    reaches a tensor-core kernel only through ``flash_variant``."""
    q = torch.zeros((1, 8, 2, 256), dtype=torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32)[None]
    before = dict(fa.flash_attention_cuda.variant_launches)
    with pytest.raises(ValueError, match="only the scalar kernel"):
        fa.flash_attention_cuda(q, q, q, pos, pos, scale=0.1, variant=variant)
    assert fa.flash_attention_cuda.variant_launches == before


def test_wide_instantiated_pairs_and_constants_match_the_source():
    """The wide entry point instantiates exactly ``WIDE_HEAD_DIMS``, pairs
    past the tensor-core kernel's 128 that no other set holds; its key tile
    is the emulation's."""
    src = CU.read_text()
    pairs = {(int(a), int(b)) for a, b in
             re.findall(r"^\s*REPRO_WIDE_CASE\((\d+), (\d+)\)", src, re.M)}
    assert pairs == set(fa.WIDE_HEAD_DIMS) == {(256, 256)}
    assert not pairs & (set(fa.MMA_HEAD_DIMS) | set(fa.MLA_HEAD_DIMS))
    assert all(d % 16 == 0 and d > 128 for pair in pairs for d in pair)
    consts = dict(re.findall(r"constexpr int (WIDE_\w+) = (\d+);", src))
    assert (int(consts["WIDE_BQ"]), int(consts["WIDE_BKV"])) == (64, WIDE_TILE)


#: the wide kernel's keys per tile (csrc WIDE_BKV)
WIDE_TILE = 32


def _emulate_wide(q, k, v, q_pos, kv_pos, *, scale, window=0):
    """The wide kernel's arithmetic in float32 on the CPU: per q head, 32-key
    tiles aligned at key 0, an online softmax with p rounded to bf16 for
    P V (as the kernel rounds it), tiles with no valid pair skipped."""
    B, Sq, Hq, Dk = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qs = (q * torch.full((), scale, dtype=q.dtype)).float()
    qp = q_pos[:, :, None, None]
    m = torch.full((B, Sq, Hq, 1), -1e30)
    l = torch.zeros((B, Sq, Hq, 1))
    acc = torch.zeros((B, Sq, Hq, v.shape[-1]))
    for t0 in range(0, Skv, WIDE_TILE):
        kb = k[:, t0:t0 + WIDE_TILE].float().repeat_interleave(g, 2)
        vb = v[:, t0:t0 + WIDE_TILE].float().repeat_interleave(g, 2)
        kp = kv_pos[:, None, None, t0:t0 + WIDE_TILE]
        valid = (kp >= 0) & (kp <= qp)
        if window:
            valid = valid & (qp - kp < window)
        if not bool(valid.any()):
            continue
        s = torch.where(valid, torch.einsum("bqhd,bkhd->bqhk", qs, kb), -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqhk,bkhd->bqhd", p.bfloat16().float(), vb)
        m = m_new
    out = torch.where(l > 0, acc / l.clamp_min(1e-30), 0.0)
    return out.bfloat16()


def _wide_inputs(B, Sq, Skv, Hq, Hkv, extra=0, seed=0):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32).bfloat16()

    q, k, v = rnd(B, Sq, Hq, 256), rnd(B, Skv, Hkv, 256), rnd(B, Skv, Hkv, 256)
    k = torch.cat([k, rnd(B, extra, Hkv, 256)], 1)
    v = torch.cat([v, rnd(B, extra, Hkv, 256)], 1)
    ar = torch.arange(Skv, dtype=torch.int32)[None]
    if Sq == Skv:                  # a left-padded prefill: 7 b pad slots
        kv_pos = torch.where(ar >= 7 * torch.arange(B)[:, None],
                             ar - 7 * torch.arange(B)[:, None], -1)
        q_pos = kv_pos
    else:
        n = Skv - 5 * torch.arange(B, dtype=torch.int32)[:, None]
        kv_pos = torch.where(ar < n, ar, -1)
        q_pos = n - Sq + ar[:, :Sq]
    kv_pos = torch.cat([kv_pos, torch.full((B, extra), -1)], 1)
    return q, k, v, q_pos.to(torch.int32), kv_pos.to(torch.int32)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,window", [(2, 40, 40, 2, 2, 0),
                                                    (2, 40, 40, 4, 1, 9),
                                                    (2, 1, 75, 4, 1, 0),
                                                    (3, 17, 70, 2, 2, 20)])
def test_wide_emulation_within_the_bar_and_blind_to_masked_slots(B, Sq, Skv, Hq,
                                                                 Hkv, window):
    """The wide kernel's tiling, emulated at head dim 256 with g 1 and 4:
    within chip_smoke.py's bf16 bar of the plain version (one ulp + 2^-7 x
    the attention of |v|; rows with no valid key exactly 0), and bitwise the
    same with trailing slots at position -1 appended."""
    scale = 1.0 / math.sqrt(256)
    q, k, v, q_pos, kv_pos = _wide_inputs(B, Sq, Skv, Hq, Hkv)
    ref = fa.attention_plain(q, k, v, q_pos, kv_pos, window=window, scale=scale)
    spread = fa.attention_plain(q, k, v.abs(), q_pos, kv_pos, window=window,
                                scale=scale).float()
    out = _emulate_wide(q, k, v, q_pos, kv_pos, scale=scale, window=window)
    big = torch.maximum(out.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    assert ((out.float() - ref.float()).abs() <= ulp + 2.0 ** -7 * spread).all()
    if Sq == Skv:                  # row 1's pad queries see no key
        assert not bool(out[1, :7].any()) and not bool(ref[1, :7].any())
    for extra in (1, 2 * WIDE_TILE + 3):
        longer = _emulate_wide(*_wide_inputs(B, Sq, Skv, Hq, Hkv, extra=extra),
                               scale=scale, window=window)
        assert torch.equal(out, longer)
