"""The kernels at ``zamba2-2.7b``'s shapes, the flash-decode op at Gemma's
head dim, and a small hybrid serve, on the card.

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_hybrid_cuda.py

* Flash in bf16 at (80, 80), the shared block's heads: one ``mma`` launch
  per call and nothing else, within ``chip_smoke.py``'s bf16 flash bar (one
  ulp of the larger output + 2^-7 x the attention of |v|) over causal and
  windowed, left-padded and ragged cases at g 1 (zamba2's 32 / 32) and g 4;
  appending masked key slots leaves the output bitwise unchanged.
* Paged attention at D 80 (m 1 and 2, g 1), against its plain version and
  bitwise equal to the ring read of the same cache.
* The SSD scan at d_state 64 (chunk 128, head_dim 64, 80 heads: zamba2's)
  on the tensor-core variant, zero and nonzero initial state, within 1e-5
  of the largest output magnitude.
* ``decode_attention`` at (256, 256) in bf16 and float32, g 1 and 8, up to
  64 query rows (the scalar kernel with K and V sharing one buffer), held
  to its bars (bf16: one ulp + 1e-6; float32: 2e-5); a head dim above 256
  is refused.
* ``zamba2-2.7b``.reduced() in bfloat16: a paged self-EAT serve on the chunk
  graphs captures, a second captures nothing, both equal an eager serve
  bitwise (tokens, exits, slots, answers, EAT traces), every flash call on
  ``mma``, every scan call on ``mma``; a ring serve equals them bitwise.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ssd_scan import ops as ss

from test_torch_cuda import (_check_paged, _decode_inputs, _ssd_inputs,
                             _within_decode_bar, _within_ssd_bar)

pytestmark = pytest.mark.gpu

D = 80


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flash_case(dev, B, Sq, Skv, Hq, Hkv, layout, extra=0, seed=0):
    """q (B, Sq, Hq, 80) against k/v (B, Skv + extra, Hkv, 80), bf16.
    ``leftpad`` (Sq == Skv): row b has 7 b pad slots, its pad queries at -1;
    ``end``: the Sq newest of row b's Skv - 5 b tokens, the rest empty.
    ``extra`` slots at position -1 (random K/V) are appended."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev).to(torch.bfloat16)

    q, k, v = rnd(B, Sq, Hq, D), rnd(B, Skv, Hkv, D), rnd(B, Skv, Hkv, D)
    k = torch.cat([k, rnd(B, extra, Hkv, D)], 1)
    v = torch.cat([v, rnd(B, extra, Hkv, D)], 1)
    ar = torch.arange(Skv, device=dev, dtype=torch.int32)[None]
    rows = torch.arange(B, device=dev, dtype=torch.int32)[:, None]
    if layout == "leftpad":
        kv_pos = torch.where(ar >= 7 * rows, ar - 7 * rows, -1)
        q_pos = kv_pos
    else:
        n = Skv - 5 * rows
        kv_pos = torch.where(ar < n, ar, -1)
        q_pos = n - Sq + ar[:, :Sq]
    kv_pos = torch.cat([kv_pos, torch.full((B, extra), -1, device=dev,
                                           dtype=torch.int32)], 1)
    return (q, k, v, q_pos.to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous())


def _within_flash_bar(out, ref, q, k, v, q_pos, kv_pos, **kw):
    """One bf16 ulp of the larger output + 2^-7 x the attention of |v|."""
    diff = (out.float() - ref.float()).abs()
    spread = fa.attention_plain(q, k, v.abs(), q_pos, kv_pos, **kw).float()
    big = torch.maximum(out.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
    return bool((diff <= ulp + 2.0 ** -7 * spread).all())


# (B, Sq, Skv, Hq, Hkv, layout, window): the shared block's prefill (g 1,
# left-padded, 512), windowed, chunks of 17 and decodes over caches off the
# 64-key tile, and g 4
FLASH_CASES = [
    (2, 512, 512, 8, 8, "leftpad", 0),
    (2, 512, 512, 4, 4, "leftpad", 100),
    (2, 17, 75, 4, 4, "end", 0),
    (3, 1, 131, 4, 4, "end", 0),
    (2, 100, 100, 8, 2, "leftpad", 24),
    (2, 17, 150, 8, 2, "end", 40),
    (1, 300, 517, 2, 2, "end", 0),
]
FLASH_IDS = [f"B{a}-Sq{b}-Skv{c}-g{d // e}-{f}-w{g}" for a, b, c, d, e, f, g in FLASH_CASES]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,layout,window", FLASH_CASES, ids=FLASH_IDS)
def test_flash_at_80_takes_mma_and_holds_the_bar(cuda, B, Sq, Skv, Hq, Hkv, layout,
                                                 window):
    args = _flash_case(cuda, B, Sq, Skv, Hq, Hkv, layout)
    kw = dict(window=window, scale=1.0 / math.sqrt(D))
    before = dict(fa.flash_attention_cuda.variant_launches)
    out = fa.flash_attention_cuda(*args, **kw)
    after = fa.flash_attention_cuda.variant_launches
    assert {x: after[x] - before[x] for x in after} == {x: int(x == "mma") for x in after}
    ref = fa.attention_plain(*args, **kw)
    assert bool(torch.isfinite(out).all())
    assert _within_flash_bar(out, ref, *args, **kw)
    if layout == "leftpad":          # pad queries see no key: exactly 0
        assert not bool(out[1, :7].any())


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,layout,window", FLASH_CASES[:4],
                         ids=FLASH_IDS[:4])
def test_flash_at_80_ignores_trailing_masked_slots_bitwise(cuda, B, Sq, Skv, Hq, Hkv,
                                                           layout, window):
    kw = dict(window=window, scale=1.0 / math.sqrt(D))
    out = fa.flash_attention_cuda(*_flash_case(cuda, B, Sq, Skv, Hq, Hkv, layout), **kw)
    for extra in (1, 64, 77):
        longer = fa.flash_attention_cuda(
            *_flash_case(cuda, B, Sq, Skv, Hq, Hkv, layout, extra=extra), **kw)
        assert torch.equal(out, longer), extra


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_at_80_matches_plain_and_ring(cuda, m, dtype):
    _check_paged(cuda, dtype, m=m, Hq=8, Hkv=8, D=D)


@pytest.mark.parametrize("case", [(4, 512, 80, 64, 1, 64, 128),
                                  (1, 300, 80, 64, 1, 64, 128)],
                         ids=["B4-S512", "B1-S300"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_at_d_state_64_on_mma(cuda, case, with_h0):
    args, h0 = _ssd_inputs(np.random.default_rng(4), case, cuda, with_h0)
    chunk = case[-1]
    assert ss.ssd_variant(chunk, case[5], case[3]) == "mma"
    before = dict(ss.ssd_scan_cuda.variant_launches)
    out = ss.ssd_scan(*args, chunk=chunk, h0=h0)
    after = ss.ssd_scan_cuda.variant_launches
    assert {x: after[x] - before[x] for x in after} == {x: int(x == "mma") for x in after}
    _within_ssd_bar(out, ss.ssd_scan_plain(*args, chunk=chunk, h0=h0))


@pytest.mark.parametrize("case", [
    # B, m, C, Hq, Hkv, window: gemma-7b's g 1 and gemma-2b's g 8 at a
    # decode, a probe and 8 rows of 8 (64 query rows: two P.V row blocks),
    # 40 rows (a partial second block), a window
    (2, 1, 1000, 16, 16, 0),
    (2, 2, 1000, 16, 16, 0),
    (2, 1, 1000, 8, 1, 0),
    (1, 8, 600, 8, 1, 0),
    (2, 5, 700, 8, 1, 0),
    (2, 1, 1000, 8, 1, 200),
], ids=["g1-m1", "g1-m2", "g8-m1", "g8-m8", "g8-m5", "g8-m1-w200"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_at_256_holds_its_bar(cuda, case, dtype):
    B, m, C, Hq, Hkv, window = case
    args = _decode_inputs(np.random.default_rng(7), cuda, dtype, B=B, m=m, C=C,
                          Hq=Hq, Hkv=Hkv, Dk=256, Dv=256, rotate=True)
    assert da.decode_variant(dtype, 256, 256) == "scalar"
    before = dict(da.decode_attention_cuda.variant_launches)
    out = da.decode_attention(*args, window=window)
    after = da.decode_attention_cuda.variant_launches
    assert {x: after[x] - before[x] for x in after} == \
        {x: int(x == "scalar") for x in after}
    ref = da.decode_attention_plain(*args, window=window, scale=1.0 / 16)
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    if dtype == torch.bfloat16:
        _within_decode_bar(out, ref)
    else:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_decode_refuses_head_dims_above_256(cuda):
    args = _decode_inputs(np.random.default_rng(0), cuda, torch.float32, B=1, m=1,
                          C=32, Hq=2, Hkv=2, Dk=272, Dv=272, rotate=False)
    with pytest.raises(ValueError, match="head dims <= 256"):
        da.decode_attention_cuda(*args, scale=0.1)


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

    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(), n_layers=12,
                              dtype="bfloat16")
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3),
                                   device=cuda))
    ecfg = EngineConfig(max_reasoning_tokens=24, capacity=256, chunk_len=8,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind=kind, attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(delta=1e9), probe=make_probe(1, (6,)),
                           schedule="every_n", every_n=3, min_evals=2)
    return ReasoningEngine(model, ecfg, mon)


def test_hybrid_graph_serve_equals_eager_serve(cuda):
    eng = _engine(cuda)
    b = np.random.default_rng(5).integers(16, eng.model.cfg.vocab, (6, 24))
    lens = np.array([24, 20, 17, 24, 9, 12])

    def serve(**kw):
        return eng.serve(b, lens, None, batch_size=4, answer_len=2,
                         record_trace=True, **kw)

    f0 = dict(fa.flash_attention_cuda.variant_launches)
    s0 = dict(ss.ssd_scan_cuda.variant_launches)
    first = serve()
    captures = eng.executor.graphs.captures
    runs = [serve(), serve(eager=True)]
    assert captures > 0 and eng.executor.graphs.captures == captures
    flash = {x: n - f0[x] for x, n in fa.flash_attention_cuda.variant_launches.items()}
    scan = {x: n - s0[x] for x, n in ss.ssd_scan_cuda.variant_launches.items()}
    assert flash["mma"] > 0 and flash["mma"] == sum(flash.values())
    assert scan["mma"] > 0 and scan["scalar"] == 0
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
