"""The overlapped serve loop on the card (``serve(overlap=True)``).

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_pipeline_cuda.py

* A warm overlapped graph serve equals the warm sync graph serve bitwise
  (tokens, exits, slots, answers, EAT traces) through the ring and the
  paged cache, self-EAT, the generator's own weights as its proxy (which
  also equals self-EAT), ``tiny-proxy`` and ``tiny-ssm``.  Every request
  exits at its 2nd evaluation, so a cohort ends inside one chunk and the
  pipeline admits behind an idle chunk, at the sync loop's ring offsets.
  Each proxy case runs three times: the shadow replays on the tier's own
  stream beside the generator's replays, which the two lanes' capture
  streams and the runners' own pools keep apart.
* The same with the generator's stream held back by a sleep enqueued after
  every dispatch, so that each chunk outlasts the shadow and the proxy's
  admissions on the tier's stream: the lagged retract then reads the
  verdict after the tier has written its own state again.
* Exits at mixed boundaries, page 16 and chunk 8: the pipeline admits
  requests behind a chunk that still runs, a part of a page later than the
  sync loop; everything is exact but those requests' EAT variances, which
  may differ in their last bits (tests/test_torch_pipeline.py shows the
  sync loop alone and the JAX package doing the same).
* Engines built in turn, more than torch's pool has streams, all kept:
  the graph runners share two lane streams.
* A warm overlapped serve captures nothing, and runs under
  ``torch.cuda.set_sync_debug_mode("error")``, greedy and sampled: its
  only waits are the events of its snapshots and answers.
* Two sampled overlapped serves from one seed are equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.serving.pipeline import PipelineHooks

pytestmark = pytest.mark.gpu

N_REQ, BATCH, BUDGET, CHUNK = 6, 4, 24, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the overlapped loop's streams need the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(cuda, arch, seed):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model, init_params

    cfg = get_config(arch)
    return Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(seed),
                                  device=cuda))


def _engine(model, *, kind="ring", proxy=None, greedy=True, delta=1e9,
            page_size=CHUNK, every_n=3):
    from repro_torch.core.eat import make_probe
    from repro_torch.core.monitor import ReasoningMonitor
    from repro_torch.core.stopping import EATStopper
    from repro_torch.serving.cache import CacheConfig
    from repro_torch.serving.engine import EngineConfig, ReasoningEngine
    from repro_torch.serving.proxy import ProxyConfig
    from repro_torch.serving.sampler import SamplerConfig

    # capacity with the overlapped loop's chunk of headroom
    ecfg = EngineConfig(max_reasoning_tokens=BUDGET, capacity=256 + CHUNK,
                        chunk_len=CHUNK, sampler=SamplerConfig(greedy=greedy),
                        cache=CacheConfig(kind=kind, page_size=page_size,
                                          attn_impl="auto"))
    mon = ReasoningMonitor(stopper=EATStopper(delta=delta), probe=make_probe(1, (6,)),
                           schedule="every_n", every_n=every_n, min_evals=2)
    return ReasoningEngine(model, ecfg, mon, proxy=None if proxy is None else
                           ProxyConfig(model=proxy))


def _prompts(model, S=20, seed=7):
    return np.random.default_rng(seed).integers(16, model.cfg.vocab, (N_REQ, S))


def _serve(eng, prompts, rng=None, **kw):
    return eng.serve(prompts, np.full(len(prompts), prompts.shape[1]), rng,
                     batch_size=BATCH, answer_len=4, record_trace=True, **kw)


def _same(a, b, *, traces=True):
    """Bitwise equal results; the EAT traces' variances only within a few
    float32 ulps (rtol 1e-6) without ``traces``."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x["n_reasoning"], x["exit_reason"], x["slot"]) == \
               (y["n_reasoning"], y["exit_reason"], y["slot"])
        np.testing.assert_array_equal(x["reasoning_tokens"], y["reasoning_tokens"])
        np.testing.assert_array_equal(x["answer_tokens"], y["answer_tokens"])
        if traces:
            assert x["eat_trace"] == y["eat_trace"]
        else:
            assert [e[:2] for e in x["eat_trace"]] == [e[:2] for e in y["eat_trace"]]
            np.testing.assert_allclose([e[2] for e in x["eat_trace"]],
                                       [e[2] for e in y["eat_trace"]],
                                       rtol=1e-6, atol=0)


def _captures(eng):
    return sum(ex.graphs.captures for ex in (eng.executor, eng.proxy_executor)
               if ex is not None)


@pytest.mark.parametrize("case", ["ring-self", "paged-self", "paged-same-proxy",
                                  "paged-tiny-proxy", "ssm-ring"])
def test_overlapped_graph_serve_equals_sync(cuda, case):
    kind, tier = case.split("-", 1)
    model = _model(cuda, "tiny-ssm" if kind == "ssm" else "tiny", 3)
    proxy = {"same-proxy": model,
             "tiny-proxy": _model(cuda, "tiny-proxy", 5)}.get(tier)
    eng = _engine(model, kind="ring" if kind == "ssm" else kind, proxy=proxy)
    prompts = _prompts(model)
    _serve(eng, prompts, overlap=True)              # cold: the captures
    ref = _serve(eng, prompts)
    assert "eat" in {r["exit_reason"] for r in ref}
    assert len({r["slot"] for r in ref}) < N_REQ     # slots recycled
    for _ in range(3 if proxy is not None else 1):
        c0 = _captures(eng)
        out = _serve(eng, prompts, overlap=True)
        assert _captures(eng) == c0
        _same(ref, out)
        assert eng._ledger.quiescent
    if tier == "same-proxy":
        _same(_serve(_engine(model, kind=kind), prompts), out)
    # a cohort that ends inside a chunk leaves the next chunk all idle
    assert eng.overlap_stats["chunks"] > 0
    if proxy is None:
        assert eng.overlap_stats["idle_chunks"] > 0


class SlowGenerator(PipelineHooks):
    """Hold the generator's stream back after every dispatch (about 30 ms
    of ``torch.cuda._sleep``)."""

    def on_dispatch(self, fence, snap):
        torch.cuda._sleep(50_000_000)


@pytest.mark.parametrize("case", ["paged-self", "paged-same-proxy",
                                  "paged-tiny-proxy", "ring-tiny-proxy"])
def test_slow_generator_stream_changes_nothing(cuda, case):
    kind, tier = case.split("-", 1)
    model = _model(cuda, "tiny", 3)
    proxy = {"same-proxy": model,
             "tiny-proxy": _model(cuda, "tiny-proxy", 5)}.get(tier)
    eng = _engine(model, kind=kind, proxy=proxy)
    prompts = _prompts(model)
    ref = _serve(eng, prompts)
    if proxy is not None:
        assert "eat" in {r["exit_reason"] for r in ref}     # proxy-stopped
    for _ in range(2):
        _same(ref, _serve(eng, prompts, overlap=True,
                          pipeline_hooks=SlowGenerator()))


def test_overlap_behind_a_running_chunk(cuda):
    """An evaluation every chunk (the trace then holds each one) and delta
    in the widest gap between the middle ones of the requests' variances
    at their 2nd evaluation, in a serve with no EAT exit: some requests
    exit there, inside a chunk, and the others run on."""
    model = _model(cuda, "tiny", 3)
    prompts = _prompts(model)
    kw = dict(kind="paged", page_size=16, every_n=CHUNK)
    full = _serve(_engine(model, delta=0.0, **kw), prompts)
    v2 = sorted(v for v in (next((e[2] for e in r["eat_trace"] if e[1] == 2),
                                 None) for r in full) if v is not None)
    _, i = max((v2[i + 1] - v2[i], i) for i in range(1, len(v2) - 2))
    eng = _engine(model, delta=(v2[i] + v2[i + 1]) / 2, **kw)
    _serve(eng, prompts, overlap=True)              # cold: the captures
    ref = _serve(eng, prompts)
    assert len({r["n_reasoning"] for r in ref}) > 1     # mixed exits
    out = _serve(eng, prompts, overlap=True)
    _same(ref, out, traces=False)
    moved = [x["request"] for x, y in zip(ref, out)
             if x["eat_trace"] != y["eat_trace"]]
    assert not set(moved) & set(range(BATCH))       # admitted requests only
    print(f"exits {[r['n_reasoning'] for r in ref]}; requests whose "
          f"variances moved: {moved}")


def test_more_engines_than_the_stream_pool(cuda):
    """33 engines built in turn and all kept, each with an overlapped
    serve: more graph runners than torch's pool has streams, and the
    process holds two lane streams."""
    from repro_torch.serving import device_loop

    model = _model(cuda, "tiny", 3)
    proxy = _model(cuda, "tiny-proxy", 5)
    prompts = _prompts(model)[:BATCH]
    kept = []
    for i in range(33):
        eng = _engine(model, kind="paged", proxy=proxy if i % 2 else None)
        assert len(_serve(eng, prompts, overlap=True)) == BATCH
        kept.append(eng)
    runners = [ex.graphs for e in kept for ex in (e.executor, e.proxy_executor)
               if ex is not None]
    assert len(runners) > 32 and all(g.captures for g in runners)
    assert len(device_loop._LANES) == 2


@pytest.mark.parametrize("greedy", [True, False])
def test_warm_overlapped_serve_waits_only_on_its_events(cuda, greedy):
    model = _model(cuda, "tiny", 3)
    for proxy in (None, _model(cuda, "tiny-proxy", 5)):
        eng = _engine(model, kind="paged", proxy=proxy, greedy=greedy)
        prompts = _prompts(model)
        _serve(eng, prompts, torch.Generator(cuda).manual_seed(0), overlap=True)
        c0 = _captures(eng)
        rng = torch.Generator(cuda).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = _serve(eng, prompts, rng, overlap=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert _captures(eng) == c0 and len(out) == N_REQ


def test_sampled_overlapped_serves_from_one_seed_are_equal(cuda):
    model = _model(cuda, "tiny", 3)
    eng = _engine(model, kind="paged", greedy=False)
    prompts = _prompts(model)
    runs = [_serve(eng, prompts, torch.Generator(cuda).manual_seed(1), overlap=True)
            for _ in range(3)]
    _same(runs[1], runs[2])
    _same(runs[0], runs[1])
