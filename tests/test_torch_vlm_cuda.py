"""The kernels at ``qwen2-vl-7b``'s shapes (28 q heads on 4 kv heads of 128:
g 7, the first odd group; the untied 3584 x 152,064 head), and a small VLM
reasoned on image patches through the chunk graphs, on the card.

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_vlm_cuda.py

* bf16 flash at (128, 128) takes the tensor-core kernel (one ``mma``
  launch) and holds the bar of ``tests/test_torch_cuda.py`` (one bf16 ulp
  + 2^-7 x the attention of |v|) against the plain version at g 7 (28/4
  and 7/1): the image prefill's layout [256 patches | pads | text] (the
  patches at 0..255 in slots before the pad slots at -1), a plain
  left-padded prompt, and decode-like rows at the end of a longer cache;
  float32 on the scalar kernel within 2e-5; masked slots appended leave
  the output bitwise unchanged.
* The paged kernel at g 7 (m 1 and 2; 28/4 and 7/1 heads of 128) within
  its bars of the plain version, and bitwise the ring read of the same
  keys.
* The entropy probe over the untied 3584 x 152,064 head at B 4 on the
  tensor-core kernel, within 1e-5 of the plain version.
* ``qwen2-vl-7b``.reduced() in bfloat16 with 7 q heads on one kv head:
  ``start(image_embeds=)`` -> ``reason()`` -> ``force_answer()`` through
  the chunk graphs equals the eager run bitwise (tokens, exits, every
  chunk's EAT and variance, answers); a second batch of patches replays
  the same graphs (no new capture) and equals its eager run; the image
  prefill launches flash ``mma`` only, one per layer.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.entropy_probe import ops as ep
from repro_torch.kernels.flash_attention import ops as fa

from test_torch_cuda import _check_paged, _tol, _within_flash_bar

pytestmark = pytest.mark.gpu

D = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flash_case(dev, dtype, B, S, Hq, Hkv, layout, P=256, extra=0, seed=0):
    """q (B, Sq, Hq, 128) against k/v (B, Skv + extra, Hkv, 128).
    ``image``: P patch slots at 0..P-1, then row b's 37 b pad slots at -1,
    then its text at P.. (Sq = Skv = P + S); ``leftpad``: row b's 37 b pad
    slots then the text at 0.. (Sq = Skv = S); ``end``: 2 queries at the
    end of row b's S - 9 b keys, the rest empty.  ``extra`` slots at -1."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev).to(dtype)

    Skv = P + S if layout == "image" else S
    ar = torch.arange(Skv, device=dev, dtype=torch.int32)[None]
    rows = torch.arange(B, device=dev, dtype=torch.int32)[:, None]
    if layout == "image":
        pad = 37 * rows
        text = ar - P - pad
        kv_pos = torch.where(ar < P, ar, torch.where(text >= 0, text + P, -1))
        q_pos = kv_pos
    elif layout == "leftpad":
        kv_pos = torch.where(ar >= 37 * rows, ar - 37 * rows, -1)
        q_pos = kv_pos
    else:
        n = S - 9 * rows
        kv_pos = torch.where(ar < n, ar, -1)
        q_pos = n - 2 + ar[:, :2]
    Sq = q_pos.shape[1]
    q, k, v = rnd(B, Sq, Hq, D), rnd(B, Skv, Hkv, D), rnd(B, Skv, Hkv, D)
    k = torch.cat([k, rnd(B, extra, Hkv, D)], 1)
    v = torch.cat([v, rnd(B, extra, Hkv, D)], 1)
    kv_pos = torch.cat([kv_pos.expand(B, Skv), torch.full((B, extra), -1, device=dev,
                                                          dtype=torch.int32)], 1)
    return (q, k, v, q_pos.expand(B, Sq).to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous())


# (B, S, Hq, Hkv, layout)
FLASH_CASES = [(2, 200, 28, 4, "image"), (3, 130, 7, 1, "image"),
               (2, 300, 28, 4, "leftpad"), (3, 261, 7, 1, "end"),
               (2, 517, 28, 4, "end")]
FLASH_IDS = [f"B{b}-S{s}-{hq}on{hk}-{lay}" for b, s, hq, hk, lay in FLASH_CASES]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,layout", FLASH_CASES, ids=FLASH_IDS)
def test_flash_at_g7_holds_the_bar(cuda, dtype, B, S, Hq, Hkv, layout):
    args = _flash_case(cuda, dtype, B, S, Hq, Hkv, layout)
    kw = dict(scale=1.0 / math.sqrt(D))
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
    if layout == "image":            # pad queries see no key: exactly 0
        assert not bool(out[1, 256:256 + 37].any())


@pytest.mark.parametrize("B,S,Hq,Hkv,layout", FLASH_CASES[:4], ids=FLASH_IDS[:4])
def test_flash_at_g7_ignores_trailing_masked_slots_bitwise(cuda, B, S, Hq, Hkv, layout):
    kw = dict(scale=1.0 / math.sqrt(D))
    out = fa.flash_attention_cuda(*_flash_case(cuda, torch.bfloat16, B, S, Hq, Hkv,
                                               layout), **kw)
    for extra in (1, 64, 77):
        args = _flash_case(cuda, torch.bfloat16, B, S, Hq, Hkv, layout, extra=extra)
        assert torch.equal(out, fa.flash_attention_cuda(*args, **kw)), extra


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("Hq,Hkv", [(28, 4), (7, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_at_g7_matches_plain_and_ring(cuda, m, Hq, Hkv, dtype):
    _check_paged(cuda, dtype, m=m, Hq=Hq, Hkv=Hkv, D=D)


def test_entropy_over_the_vlm_head_on_mma(cuda):
    g = torch.Generator(cuda).manual_seed(0)
    d, Vp = 3584, 152_064
    h = torch.randn((4, d), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((d, Vp), generator=g, device=cuda) * (2.0 / d ** 0.5)).to(torch.bfloat16)
    assert ep.entropy_variant(h, w) == "mma"
    before = dict(ep.entropy_probe_cuda.variant_launches)
    out = ep.entropy_probe_cuda(h, w, Vp)
    after = ep.entropy_probe_cuda.variant_launches
    assert {x: after[x] - before[x] for x in after} == {x: int(x == "mma") for x in after}
    torch.testing.assert_close(out, ep.next_token_entropy_plain(h, w, Vp),
                               atol=1e-5, rtol=1e-5)


# ------------------------------------------------------- a reduced model


def _engine(cuda):
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig

    cfg = dataclasses.replace(get_config("qwen2-vl-7b").reduced(), n_heads=7,
                              n_kv_heads=1, dtype="bfloat16")
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3),
                                   device=cuda))
    ecfg = EngineConfig(max_reasoning_tokens=24, capacity=96, chunk_len=8,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind="ring", attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(delta=1e9), probe=make_probe(1, (6,)),
                           schedule="every_n", every_n=3, min_evals=2)
    return ReasoningEngine(model, ecfg, mon)


def _patches(cfg, B, seed, dev):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn((B, cfg.n_image_patches, cfg.d_model), generator=g, device=dev)


def _trace(executor, trace):
    chunk = executor.decode_chunk

    def run(*a, **kw):
        st = chunk(*a, **kw)
        s = st.monitor.stop_state
        trace.append([x.clone() for x in (st.n_reasoning, st.monitor.n_evals, s.last,
                                          s.ema.var, st.active)])
        return st
    executor.decode_chunk = run


def _reason(eng, prompts, lens, img, eager):
    trace = []
    _trace(eng.executor, trace)
    try:
        st = eng.reason(eng.start(prompts, lens, None, image_embeds=img), eager=eager)
        ans, _ = eng.force_answer(st, 3, greedy=True, eager=eager)
    finally:
        del eng.executor.decode_chunk
    return [st.out_tokens.clone(), st.n_reasoning.clone(),
            st.monitor.stop_flag.clone(), ans.clone()], trace


def test_graph_reason_on_patches_equals_eager_and_replays_new_patches(cuda):
    eng = _engine(cuda)
    cfg = eng.model.cfg
    rng = np.random.default_rng(5)
    prompts = rng.integers(16, cfg.vocab, (4, 24))
    lens = np.array([24, 20, 17, 9])
    f0 = dict(fa.flash_attention_cuda.variant_launches)
    img = _patches(cfg, 4, 1, cuda)
    eng.start(prompts, lens, None, image_embeds=img)
    flash = {x: n - f0[x] for x, n in fa.flash_attention_cuda.variant_launches.items()}
    assert flash == {x: cfg.n_layers * (x == "mma") for x in flash}
    first, ftrace = _reason(eng, prompts, lens, img, eager=False)
    captures = eng.executor.graphs.captures
    assert captures > 0
    eager, etrace = _reason(eng, prompts, lens, img, eager=True)
    img2 = _patches(cfg, 4, 2, cuda)
    second, strace = _reason(eng, prompts, lens, img2, eager=False)
    assert eng.executor.graphs.captures == captures
    second_eager, setrace = _reason(eng, prompts, lens, img2, eager=True)
    for a, b, ta, tb in ((first, eager, ftrace, etrace),
                         (second, second_eager, strace, setrace)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert len(ta) == len(tb)
        assert all(torch.equal(x, y) for ra, rb in zip(ta, tb) for x, y in zip(ra, rb))
    assert bool(first[2].any())
    assert not all(torch.equal(x, y) for x, y in zip(first, second))
