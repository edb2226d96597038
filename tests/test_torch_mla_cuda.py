"""Multi-head latent attention on the card.

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mla_cuda.py

* The flash kernel at MLA's shapes against its plain version: the absorbed
  form (one kv head of 576 = 512 + 64, values the 512-wide latent) at a
  prefill and at a decode, and the expanded training form (192/128), in
  float32 (1e-5) and bfloat16 (one ulp + 2^-7 of the attention of |v|,
  ``chip_smoke.py``'s bar); every call on the scalar kernel.
* ``deepseek-v2-236b``.reduced() in bfloat16: a paged self-EAT serve on the
  chunk graphs captures, a second serve captures nothing, and both equal
  an eager serve bitwise (tokens, exits, slots, answers, EAT traces), with
  no paged-attention launch (MLA reads through the gathered view).
"""
import math

import numpy as np
import pytest
import torch

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
        k, v = torch.cat([c, kr], dim=-1)[:, :, None, :], c[:, :, None, :]
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
    from repro_torch.kernels.flash_attention import ops as fa

    args = _case(cuda, dtype, m, C, expanded)
    scale = 1.0 / math.sqrt(128 + 64)
    before = dict(fa.flash_attention_cuda.variant_launches)
    out = fa.flash_attention_cuda(*args, scale=scale)
    after = fa.flash_attention_cuda.variant_launches
    assert {x: after[x] - before[x] for x in after} == {"mma": 0, "scalar": 1}
    ref = fa.attention_plain(*args, scale=scale)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5
    else:
        q, k, v, q_pos, kv_pos = args
        spread = fa.attention_plain(q, k, v.abs(), q_pos, kv_pos, scale=scale).float()
        big = torch.maximum(out.float().abs(), ref.float().abs())
        ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 8)
        assert (diff <= ulp + 2.0 ** -7 * spread).all()


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

    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(), dtype="bfloat16")
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3),
                                   device=cuda))
    ecfg = EngineConfig(max_reasoning_tokens=24, capacity=256, chunk_len=8,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind="paged", attn_impl="auto"))
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
    first = serve()
    captures = eng.executor.graphs.captures
    runs = [serve(), serve(eager=True)]
    assert captures > 0 and eng.executor.graphs.captures == captures
    assert paged_attention_cuda.launches == paged0
    assert flash_attention_cuda.launches > flash0
    assert "eat" in [r["exit_reason"] for r in first]
    for other in runs:
        assert len(other) == len(first) == 6
        for a, o in zip(first, other):
            assert (a["n_reasoning"], a["exit_reason"], a["slot"]) == \
                   (o["n_reasoning"], o["exit_reason"], o["slot"])
            assert a["eat_trace"] == o["eat_trace"]
            np.testing.assert_array_equal(a["reasoning_tokens"], o["reasoning_tokens"])
            np.testing.assert_array_equal(a["answer_tokens"], o["answer_tokens"])
