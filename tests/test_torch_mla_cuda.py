"""Multi-head latent attention on the card.

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mla_cuda.py

* The flash kernel at MLA's shapes against its plain version: the absorbed
  form (one kv head of 576 = 512 + 64, values the 512-wide latent, handed
  as the view ``k[..., :512]``) at a prefill and at a decode, and the
  expanded training form (192/128), in float32 (1e-5) and bfloat16 (one
  ulp + 2^-7 of the attention of |v|, ``chip_smoke.py``'s bar); bf16
  absorbed calls on the MLA kernel (``"mla"``), float32 and the expanded
  form on the scalar kernel.
* The MLA kernel at (576, 512) and (48, 32) on ragged cases: 128 heads and
  head counts that are not a multiple of its 64-row tile, m > 1 across
  tiles, key counts that are not a multiple of its key tile or split, a
  left-padded prefill, a sliding window, rows with no valid key; with and
  without the key splits.  Appending two whole splits of empty slots
  leaves its output bitwise unchanged, split or not; a v that is not the
  view of k is refused.
* ``deepseek-v2-236b``.reduced() in bfloat16: a paged self-EAT serve on the
  chunk graphs captures, a second serve captures nothing, and both equal
  an eager serve bitwise (tokens, exits, slots, answers, EAT traces), with
  no paged-attention launch (MLA reads through the gathered view) and every
  flash call on the MLA kernel; a ring serve equals them bitwise.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the flash kernel and the chunk graphs need the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, m, C, expanded, B=2, H=8, seed=0):
    g = torch.Generator(dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    if expanded:
        q, k, v = rnd(B, m, H, 192), rnd(B, C, H, 192), rnd(B, C, H, 128)
    else:
        q, c, kr = rnd(B, m, H, 576), rnd(B, C, 512), rnd(B, C, 64)
        k = torch.cat([c, kr], dim=-1)[:, :, None, :]
        v = k[..., :512]
    ar = torch.arange(C, device=dev, dtype=torch.int32)[None]
    n = C - 7 * torch.arange(B, device=dev, dtype=torch.int32)[:, None]
    kv_pos = torch.where(ar < n, ar, -1).to(torch.int32).contiguous()
    q_pos = (n - m + ar[:, :m]).to(torch.int32).contiguous()
    return q, k, v, q_pos, kv_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,C,expanded", [(40, 40, False), (1, 70, False),
                                          (40, 40, True)],
                         ids=["absorbed-prefill", "absorbed-decode", "expanded"])
def test_flash_at_mla_shapes_matches_plain(cuda, dtype, m, C, expanded):
    args = _case(cuda, dtype, m, C, expanded)
    scale = 1.0 / math.sqrt(128 + 64)
    before = dict(fa.flash_attention_cuda.variant_launches)
    out = fa.flash_attention_cuda(*args, scale=scale)
    after = fa.flash_attention_cuda.variant_launches
    want = "mla" if dtype == torch.bfloat16 and not expanded else "scalar"
    assert {x: after[x] - before[x] for x in after} == {
        x: int(x == want) for x in after}
    ref = fa.attention_plain(*args, scale=scale)
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-5
    else:
        assert _within_bar(out, ref, *args, scale=scale)


def _within_bar(out, ref, q, k, v, q_pos, kv_pos, **kw):
    """One bf16 ulp of the larger output + 2^-7 x the attention of |v|."""
    diff = (out.float() - ref.float()).abs()
    spread = fa.attention_plain(q, k, v.abs(), q_pos, kv_pos, **kw).float()
    big = torch.maximum(out.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return bool((diff <= ulp + 2.0 ** -7 * spread).all())


def _mla_case(dev, Dk, Dv, B, m, C, H, layout, seed=0, extra=0):
    """MLA's absorbed inputs in bf16: q (B, m, H, Dk) against one kv head k
    = cat(c, kr) (B, C + extra, 1, Dk), v = k[..., :Dv].  ``leftpad`` (m ==
    C): row b has 7 b pad slots, pad queries at position -1 (no valid key);
    ``end``: the m newest of row b's C - 7 b tokens, the rest empty;
    ``empty``: as ``end`` with row 0 holding no key at all.  ``extra`` key
    slots at position -1 (random K) are appended."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev).to(torch.bfloat16)

    q, k = rnd(B, m, H, Dk), rnd(B, C, 1, Dk)
    k = torch.cat([k, rnd(B, extra, 1, Dk)], 1)
    ar = torch.arange(C, device=dev, dtype=torch.int32)[None]
    rows = torch.arange(B, device=dev, dtype=torch.int32)[:, None]
    if layout == "leftpad":
        kv_pos = torch.where(ar >= 7 * rows, ar - 7 * rows, -1)
        q_pos = kv_pos
    else:
        n = C - 7 * rows
        kv_pos = torch.where(ar < n, ar, -1)
        q_pos = n - m + ar[:, :m]
        if layout == "empty":
            kv_pos[0] = -1
    kv_pos = torch.cat([kv_pos, torch.full((B, extra), -1, device=dev,
                                           dtype=torch.int32)], 1)
    return (q, k, k[..., :Dv], q_pos.to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous())


# (Dk, Dv, B, m, C, H, layout, window): split decodes and probes, split and
# unsplit prefills, g = 128 and g not a multiple of the 64-row tile, key
# counts off the 32-key tile and the 64-key split
RAGGED = [
    (576, 512, 2, 1, 131, 128, "end", 0),
    (576, 512, 2, 5, 200, 128, "end", 0),
    (576, 512, 2, 80, 80, 128, "leftpad", 0),
    (576, 512, 2, 7, 100, 40, "end", 16),
    (576, 512, 2, 70, 70, 128, "empty", 0),
    (576, 512, 2, 70, 90, 128, "end", 24),
    (48, 32, 2, 1, 70, 4, "end", 0),
    (48, 32, 3, 300, 300, 4, "leftpad", 0),
    (48, 32, 2, 500, 520, 20, "end", 0),
    (48, 32, 2, 33, 33, 4, "leftpad", 5),
    (48, 32, 2, 9, 75, 4, "empty", 0),
]


@pytest.mark.parametrize("Dk,Dv,B,m,C,H,layout,window", RAGGED,
                         ids=[f"{a}-{b}-B{c}-m{d}-C{e}-H{f}-{g}-w{h}"
                              for a, b, c, d, e, f, g, h in RAGGED])
def test_mla_kernel_ragged_matches_plain(cuda, Dk, Dv, B, m, C, H, layout, window):
    args = _mla_case(cuda, Dk, Dv, B, m, C, H, layout)
    kw = dict(window=window, scale=1.0 / math.sqrt(Dk - Dv + 128))
    assert fa.flash_variant(torch.bfloat16, Dk, Dv) == "mla"
    before = dict(fa.flash_attention_cuda.variant_launches)
    out = fa.flash_attention_cuda(*args, **kw)
    after = fa.flash_attention_cuda.variant_launches
    assert {x: after[x] - before[x] for x in after} == {
        x: int(x == "mla") for x in after}
    ref = fa.attention_plain(*args, **kw)
    assert _within_bar(out, ref, *args, **kw)
    if layout == "empty":
        assert torch.equal(out[0], torch.zeros_like(out[0]))
    if layout == "leftpad":
        assert not out[1, :7].any()    # pad queries: no valid key


@pytest.mark.parametrize("Dk,Dv,B,m,C,H,layout,split", [
    (576, 512, 2, 80, 80, 128, "leftpad", False),   # one launch over every key
    (576, 512, 4, 1, 704, 128, "end", True),        # the serve's decode
    (48, 32, 2, 500, 520, 20, "end", False),
    (48, 32, 2, 3, 75, 4, "end", True),
], ids=["prefill", "decode-split", "reduced-prefill", "reduced-split"])
def test_mla_kernel_ignores_two_empty_splits_bitwise(cuda, Dk, Dv, B, m, C, H, layout,
                                                     split):
    """Two whole splits of empty slots (position -1, random K) appended
    leave the output bitwise unchanged, with or without the key splits:
    the paged == ring property of the MLA serves."""
    extra = 2 * fa.MLA_SPLIT_KEYS
    short = _mla_case(cuda, Dk, Dv, B, m, C, H, layout)
    long = _mla_case(cuda, Dk, Dv, B, m, C, H, layout, extra=extra)
    assert torch.equal(long[0], short[0])
    assert torch.equal(long[1][:, :C], short[1])
    n_split = fa.mla_splits(B, m, H, 1, C)
    assert (n_split > 0) == split
    assert fa.mla_splits(B, m, H, 1, C + extra) == (n_split + 2 if split else 0)
    kw = dict(scale=1.0 / math.sqrt(Dk))
    a = fa.flash_attention_cuda(*short, **kw)
    b = fa.flash_attention_cuda(*long, **kw)
    assert torch.equal(a, b)


def test_mla_kernel_refuses_a_v_that_is_not_the_view_of_k(cuda):
    q, k, v, q_pos, kv_pos = _mla_case(cuda, 576, 512, 1, 1, 40, 128, "end")
    with pytest.raises(ValueError, match="k\\[..., :Dv\\]"):
        fa.flash_attention_cuda(q, k, v.contiguous(), q_pos, kv_pos, scale=0.1)


def _engine(cuda, kind="paged"):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig

    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(), dtype="bfloat16")
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3),
                                   device=cuda))
    ecfg = EngineConfig(max_reasoning_tokens=24, capacity=256, chunk_len=8,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind=kind, attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(delta=1e9), probe=make_probe(1, (6,)),
                           schedule="every_n", every_n=3, min_evals=2)
    return ReasoningEngine(model, ecfg, mon)


def test_mla_graph_serve_equals_eager_serve(cuda):
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.paged_attention.ops import paged_attention_cuda

    eng = _engine(cuda)
    b = np.random.default_rng(5).integers(16, eng.model.cfg.vocab, (6, 24))
    lens = np.array([24, 20, 17, 24, 9, 12])

    def serve(**kw):
        return eng.serve(b, lens, None, batch_size=4, answer_len=2,
                         record_trace=True, **kw)

    paged0, flash0 = paged_attention_cuda.launches, flash_attention_cuda.launches
    variants0 = dict(flash_attention_cuda.variant_launches)
    first = serve()
    captures = eng.executor.graphs.captures
    runs = [serve(), serve(eager=True)]
    assert captures > 0 and eng.executor.graphs.captures == captures
    assert paged_attention_cuda.launches == paged0
    assert flash_attention_cuda.launches > flash0
    variants = {x: n - variants0[x] for x, n in flash_attention_cuda.variant_launches.items()}
    assert variants["mla"] == flash_attention_cuda.launches - flash0
    assert variants["mma"] == variants["scalar"] == 0
    assert "eat" in [r["exit_reason"] for r in first]
    ring = _engine(cuda, "ring")
    runs.append(ring.serve(b, lens, None, batch_size=4, answer_len=2,
                           record_trace=True))
    for i, other in enumerate(runs):
        assert len(other) == len(first) == 6
        for a, o in zip(first, other):
            assert (a["n_reasoning"], a["exit_reason"]) == \
                   (o["n_reasoning"], o["exit_reason"])
            assert i == 2 or a["slot"] == o["slot"]
            assert a["eat_trace"] == o["eat_trace"]
            np.testing.assert_array_equal(a["reasoning_tokens"], o["reasoning_tokens"])
            np.testing.assert_array_equal(a["answer_tokens"], o["answer_tokens"])
