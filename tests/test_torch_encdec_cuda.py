"""Flash run non-causally at ``seamless-m4t-large-v2``'s head dim, and a
small encoder-decoder reasoned through the chunk graphs, on the card.

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_encdec_cuda.py

* Flash with ``causal=False`` at (64, 64), bf16 (one ``mma`` launch) and
  float32 (one ``scalar`` launch), against the plain version within the
  bars of ``tests/test_torch_cuda.py`` (2e-5 float32; 3e-2 and one bf16
  ulp + 2^-7 x the attention of |v| in bf16): cross-attention's shape,
  every query at position 0, at m 1, 2 and 512 against 1024 frames and a
  ragged 777 with invalid (-1) frames at each row's end; the encoder's
  self-attention (queries at 0..T-1) over 1024 frames.  Appending masked
  key slots leaves the output bitwise unchanged.
* ``seamless-m4t-large-v2``.reduced() in bfloat16 (heads of 32): a ring
  and a paged cache of the same prefill give bitwise equal decodes on the
  page-native kernel (the cross K/V packed whole); ``start(frames=)`` ->
  ``reason()`` through the chunk graphs equals the eager reason bitwise
  (tokens, exits, every chunk's EAT and variance, forced answers), a
  second ``start()`` with other frames replays the captured graphs (no
  new capture) and equals its eager run; the prefill launches flash
  ``mma`` only, 2 + 2 x 2 per prefill, and each decode forward one flash
  and one paged call per decoder layer.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa

from test_torch_cuda import _tol, _within_flash_bar

pytestmark = pytest.mark.gpu

D = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, B, m, T, H, ragged, *, encoder=False, extra=0, seed=0):
    """q (B, m, H, 64) against k/v (B, T + extra, H, 64).  Queries at 0
    (cross-attention) or, with ``encoder`` (m == T), at 0..T-1; with
    ``ragged`` row b's last 29 b frames are invalid; ``extra`` appended
    slots at -1 (random K/V)."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev).to(dtype)

    q, k, v = rnd(B, m, H, D), rnd(B, T, H, D), rnd(B, T, H, D)
    k = torch.cat([k, rnd(B, extra, H, D)], 1)
    v = torch.cat([v, rnd(B, extra, H, D)], 1)
    ar = torch.arange(T, device=dev, dtype=torch.int32)[None].expand(B, T)
    rows = torch.arange(B, device=dev, dtype=torch.int32)[:, None]
    kv_pos = torch.where(ar < T - 29 * rows, ar, -1) if ragged else ar
    kv_pos = torch.cat([kv_pos, torch.full((B, extra), -1, device=dev,
                                           dtype=torch.int32)], 1).contiguous()
    q_pos = (ar.contiguous() if encoder
             else torch.zeros((B, m), dtype=torch.int32, device=dev))
    return q, k, v, q_pos, kv_pos


# (B, m, T, heads, ragged, encoder): cross-attention at a decode step, a
# 2-token probe and a 512-token prompt over 1024 frames and a ragged 777;
# the encoder's self-attention over 1024 frames
CASES = [(2, 1, 1024, 16, False, False), (2, 2, 1024, 16, False, False),
         (2, 512, 1024, 16, False, False), (3, 1, 777, 16, True, False),
         (3, 512, 777, 4, True, False), (2, 1024, 1024, 16, False, True)]
IDS = [f"B{b}-m{m}-T{t}-{'ragged' if r else 'full'}{'-encoder' if e else ''}"
       for b, m, t, _, r, e in CASES]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,m,T,H,ragged,encoder", CASES, ids=IDS)
def test_noncausal_flash_at_64_holds_the_bar(cuda, dtype, B, m, T, H, ragged,
                                             encoder):
    args = _case(cuda, dtype, B, m, T, H, ragged, encoder=encoder)
    kw = dict(causal=False, scale=1.0 / math.sqrt(D))
    want = "mma" if dtype == torch.bfloat16 else "scalar"
    assert fa.flash_variant(dtype, D, D) == want
    before = dict(fa.flash_attention_cuda.variant_launches)
    out = fa.flash_attention_cuda(*args, **kw)
    after = fa.flash_attention_cuda.variant_launches
    assert {x: after[x] - before[x] for x in after} == {x: int(x == want) for x in after}
    ref = fa.attention_plain(*args, **kw)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype), rtol=_tol(dtype))
    if dtype == torch.bfloat16:
        assert _within_flash_bar(out, ref, *args, kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,m,T,H,ragged,encoder", CASES[:4] + CASES[5:], ids=IDS[:4] + IDS[5:])
def test_noncausal_flash_ignores_trailing_masked_slots_bitwise(cuda, dtype, B, m, T, H,
                                                               ragged, encoder):
    kw = dict(causal=False, scale=1.0 / math.sqrt(D))
    out = fa.flash_attention_cuda(*_case(cuda, dtype, B, m, T, H, ragged,
                                         encoder=encoder), **kw)
    for extra in (1, 64, 77):
        args = _case(cuda, dtype, B, m, T, H, ragged, encoder=encoder, extra=extra)
        assert torch.equal(out, fa.flash_attention_cuda(*args, **kw)), extra


# ------------------------------------------------------- a reduced model


def _model(cuda):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model, init_params

    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2").reduced(),
                              dtype="bfloat16")
    return Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3),
                                  device=cuda))


def _frames(cfg, B, seed, dev):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn((B, cfg.encoder_len, cfg.d_model), generator=g, device=dev)


def test_ring_and_paged_decodes_are_bitwise_equal(cuda):
    from repro_torch.serving.cache import alloc_cache, alloc_paged_cache, blocks_arrays
    from repro_torch.serving.cache import pack_paged_cache

    model = _model(cuda)
    model.paged_attn_impl = "auto"
    cfg = model.cfg
    B, S, C, ps = 2, 24, 64, 16
    toks = torch.randint(4, cfg.vocab, (B, S), device=cuda)
    pos = torch.arange(S, dtype=torch.int32, device=cuda).expand(B, S).contiguous()
    fr = _frames(cfg, B, 1, cuda)
    dense = alloc_cache(cfg, B, 32, device=cuda)
    model.prefill(toks, pos, pos, dense, frames=fr)
    ring = alloc_cache(cfg, B, C, device=cuda)
    model.prefill(toks, pos, pos, ring, frames=fr)
    paged = alloc_paged_cache(cfg, B, C, ps, 1 + B * C // ps, device=cuda)
    table = np.arange(1, 1 + B * C // ps, dtype=np.int32).reshape(B, C // ps)
    pack_paged_cache(paged, dense, table)
    n = np.full(B, C // ps, np.int32)
    logical = np.broadcast_to(np.arange(C // ps, dtype=np.int32), (B, C // ps)).copy()
    paged["blocks"] = blocks_arrays(table, logical, n, device=cuda)
    for e_r, e_p in zip(ring["layers"], paged["layers"]):
        assert torch.equal(e_r["ck"], e_p["ck"]) and torch.equal(e_r["cv"], e_p["cv"])
    nxt = torch.full((B, 1), 7, dtype=torch.long, device=cuda)
    p1 = torch.full((B, 1), S, dtype=torch.int32, device=cuda)
    f0, c0 = fa.flash_attention_cuda.launches, pa.paged_attention_cuda.launches
    a = model.decode_step(nxt, p1, p1, ring)
    assert (fa.flash_attention_cuda.launches - f0,
            pa.paged_attention_cuda.launches - c0) == (cfg.n_layers, cfg.n_layers)
    b = model.decode_step(nxt, p1, p1, paged)
    assert torch.equal(a, b)


def _trace(executor, trace):
    chunk = executor.decode_chunk

    def run(*a, **kw):
        st = chunk(*a, **kw)
        s = st.monitor.stop_state
        trace.append([x.clone() for x in (st.n_reasoning, st.monitor.n_evals, s.last,
                                          s.ema.var, st.active)])
        return st
    executor.decode_chunk = run


def _reason(eng, prompts, lens, fr, eager):
    trace = []
    _trace(eng.executor, trace)
    try:
        st = eng.reason(eng.start(prompts, lens, None, frames=fr), eager=eager)
        ans, _ = eng.force_answer(st, 3, greedy=True, eager=eager)
    finally:
        del eng.executor.decode_chunk
    return [st.out_tokens.clone(), st.n_reasoning.clone(),
            st.monitor.stop_flag.clone(), ans.clone()], trace


def test_graph_reason_equals_eager_and_replays_with_new_frames(cuda):
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig

    model = _model(cuda)
    cfg = model.cfg
    ecfg = EngineConfig(max_reasoning_tokens=24, capacity=96, chunk_len=8,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind="ring", attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(delta=1e9), probe=make_probe(1, (6,)),
                           schedule="every_n", every_n=3, min_evals=2)
    eng = ReasoningEngine(model, ecfg, mon)
    rng = np.random.default_rng(5)
    prompts = rng.integers(16, cfg.vocab, (4, 24))
    lens = np.array([24, 20, 17, 9])
    f0 = dict(fa.flash_attention_cuda.variant_launches)
    first, ftrace = _reason(eng, prompts, lens, _frames(cfg, 4, 1, cuda), eager=False)
    flash = {x: n - f0[x] for x, n in fa.flash_attention_cuda.variant_launches.items()}
    assert flash["mma"] > 0 and flash["mma"] == sum(flash.values())
    captures = eng.executor.graphs.captures
    assert captures > 0
    eager, etrace = _reason(eng, prompts, lens, _frames(cfg, 4, 1, cuda), eager=True)
    fr2 = _frames(cfg, 4, 2, cuda)
    second, strace = _reason(eng, prompts, lens, fr2, eager=False)
    assert eng.executor.graphs.captures == captures
    second_eager, setrace = _reason(eng, prompts, lens, fr2, eager=True)
    for a, b, ta, tb in ((first, eager, ftrace, etrace),
                         (second, second_eager, strace, setrace)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert len(ta) == len(tb)
        assert all(torch.equal(x, y) for ra, rb in zip(ta, tb) for x, y in zip(ra, rb))
    assert bool(first[2].any())
    assert not all(torch.equal(x, y) for x, y in zip(first, second))
