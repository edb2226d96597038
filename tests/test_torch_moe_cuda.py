"""The mixture-of-experts family on the card.

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_cuda.py

* ``moe_apply`` runs eagerly and is captured into a CUDA graph under
  ``torch.cuda.set_sync_debug_mode("error")`` (no host read anywhere in
  the router, the dispatch or the combine), dropless and capacity-bound,
  float32 and bfloat16;
  a replay equals the eager call bitwise, and two eager calls equal each
  other (the combine adds in a fixed order, with no atomics).
* ``moe_apply`` on the card equals the CPU's within 1e-5 (float32, TF32
  off), dropless and capacity-bound.
* ``tiny-moe``: a decode chunk as a CUDA-graph replay equals the eager
  guarded chunk bitwise, ring and paged (the state and the whole cache);
  a second serve of the engine captures nothing and equals the first and
  an eager serve bitwise.
"""
import contextlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the chunk graphs and the capture of moe_apply "
                    "need the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer(device, dtype=torch.float32):
    """tiny-moe's MoE layer (4 experts, top 2, one shared) on ``device``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.moe import moe_init

    cfg = get_config("tiny-moe")
    p = moe_init(torch.Generator(device).manual_seed(0), cfg, dtype, device)
    return cfg, p


@contextlib.contextmanager
def _no_sync():
    """Any host sync inside raises (sync debug mode "error")."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


# (B, S): T k = 2048 <= 4096, dropless; T k = 8192, capacity-bound
SHAPES = [(4, 256), (8, 512)]


@pytest.mark.parametrize("shape", SHAPES, ids=["dropless", "capacity-bound"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_captures_without_host_sync(cuda, shape, dtype):
    from repro_torch.models.moe import moe_apply

    cfg, p = _layer(cuda, dtype)
    x = torch.randn(*shape, cfg.d_model, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda).to(dtype)
    torch.cuda.synchronize()
    with _no_sync():
        y0, aux0 = moe_apply(p, x, cfg)
        y1, _ = moe_apply(p, x, cfg)
    assert torch.equal(y0, y1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe_apply(p, x, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with _no_sync():
            y, aux = moe_apply(p, x, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


@pytest.mark.parametrize("shape", SHAPES, ids=["dropless", "capacity-bound"])
def test_moe_apply_on_the_card_matches_the_cpu(cuda, shape):
    from repro_torch.models.moe import moe_apply

    cfg, p = _layer(torch.device("cpu"))
    x = torch.randn(*shape, cfg.d_model, generator=torch.Generator().manual_seed(1))
    ref, ref_aux = moe_apply(p, x, cfg)

    def to(t):
        return {k: to(v) for k, v in t.items()} if isinstance(t, dict) else t.to(cuda)

    y, aux = moe_apply(to(p), x.to(cuda), cfg)
    np.testing.assert_allclose(y.cpu().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)


def _engine(cuda, kind):
    from repro_torch.configs.base import get_config
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.models.model import Model, init_params
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.sampler import SamplerConfig

    cfg = get_config("tiny-moe")
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3),
                                   device=cuda))
    ecfg = EngineConfig(max_reasoning_tokens=24, capacity=256, chunk_len=8,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind=kind, attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(delta=1e9), probe=make_probe(1, (6,)),
                           schedule="every_n", every_n=3, min_evals=2)
    return ReasoningEngine(model, ecfg, mon)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    return tree


@pytest.mark.parametrize("kind", ["ring", "paged"])
def test_moe_chunk_graph_equals_the_eager_chunk(cuda, kind):
    """Two chunks (the first captures, the second replays), each against
    the eager guarded chunk from a copy of the same state."""
    eng = _engine(cuda, kind)
    prompts = np.random.default_rng(7).integers(16, eng.model.cfg.vocab, (4, 20))
    ss = eng._serve_setup(prompts, np.full(4, 20), None, batch_size=4,
                          max_tokens=24, chunk_len=8)
    state = ss.state
    for _ in range(2):
        if ss.paged:
            state = eng.executor.ensure_chunk_pages(ss.alloc, state, [0, 1, 2, 3],
                                                    ss.chunk + 2,
                                                    cur=int(state.cache["cur"]))
        ref = eng.executor.decode_chunk(_clone(state), ss.budget, ss.chunk, eager=True)
        state = eng.executor.decode_chunk(state, ss.budget, ss.chunk)
        la, lb = _tensors(ref), _tensors(state)
        assert len(la) == len(lb) and all(torch.equal(a, b) for a, b in zip(la, lb))
    assert eng.executor.graphs.captures == 1 and eng.executor.graphs.replays == 2


def test_moe_second_serve_makes_no_capture(cuda):
    eng = _engine(cuda, "paged")
    b = np.random.default_rng(5).integers(16, eng.model.cfg.vocab, (6, 24))
    lens = np.array([24, 20, 17, 24, 9, 12])

    def serve(**kw):
        return eng.serve(b, lens, None, batch_size=4, answer_len=2,
                         record_trace=True, **kw)

    first = serve()
    captures = eng.executor.graphs.captures
    runs = [serve(), serve(eager=True)]
    assert captures > 0 and eng.executor.graphs.captures == captures
    assert "eat" in [r["exit_reason"] for r in first]
    for other in runs:
        for a, o in zip(first, other):
            assert a["eat_trace"] == o["eat_trace"] and a["slot"] == o["slot"]
            np.testing.assert_array_equal(a["reasoning_tokens"], o["reasoning_tokens"])
            np.testing.assert_array_equal(a["answer_tokens"], o["answer_tokens"])
