"""The fused decode-and-probe step on the card, bf16.

Marked ``gpu`` and skipped without a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fused_probe_cuda.py

* The paged kernel at the fused step's width, m 3 (1 + the probe's 2), at
  g 1, 4 and 8 (3 to 24 rows per kv head): within one bf16 ulp of its
  plain version (float32 within 1e-6), and equal to the ring's read of the
  same keys bitwise.
* A reduced bf16 dense model (``qwen3-1.7b``.reduced(), 4 q heads on 1 kv
  head: g 4) on a paged cache and on the ring, both through the paged
  kernel: the fused step against the separate step (``decode_step`` then
  ``probe_entropy``) from one cache state, and the two decode steps after
  each, within the smoke's dense bars (relative L2 and max |diff| / max
  |logits| 3e-2, EAT 6e-2 nats); one paged call per layer and one entropy
  call per fused step, no flash; the paged results equal the ring's
  bitwise.
* A reduced bf16 MLA model (``deepseek-v2-236b``.reduced()): its fused step
  launches flash on the MLA kernel alone (m 3), one call per layer, and
  holds the same bars against the separate step.
* A reduced bf16 hybrid (``zamba2-2.7b``.reduced()): its fused step is the
  separate step bitwise, the probe read by flash or by the paged kernel.
* The fused step's probe slots past a row's mapped pages (their K/V in the
  trash page, which the page-native read skips), then two decode steps
  once the block is mapped: the paged kernel against its plain version on
  the same cache, float32 within 1e-4 and bf16 within the dense bars.
* ``build_serve_step_program(fused_probe=True)``: 8 greedy every-token
  steps captured as one CUDA graph; its cold and warm replays equal the
  eager run bitwise (tokens, monitor state, cache).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.entropy_probe import ops as ep
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa

from test_torch_cuda import _check_paged

pytestmark = pytest.mark.gpu

PROBE = (1, 6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (32, 8), (16, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_at_m3(cuda, Hq, Hkv, dtype):
    _check_paged(cuda, dtype, m=3, Hq=Hq, Hkv=Hkv, D=128)


def _model(cuda, name, **kw):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model, init_params

    cfg = dataclasses.replace(get_config(name).reduced(), **{"dtype": "bfloat16", **kw})
    model = Model(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(3), device=cuda),
                  paged_attn_impl="auto", paged_attn_page=16)
    return model


def _caches(model, cuda, B=2, S=40, C=64, ps=16):
    """A ring and a paged cache (shuffled pages) after one prefill."""
    from repro_torch.serving.cache import (alloc_cache, alloc_paged_cache,
                                           blocks_arrays, pack_paged_cache)

    cfg = model.cfg
    toks = torch.randint(4, cfg.vocab, (B, S), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    pos = torch.arange(S, dtype=torch.int32, device=cuda).expand(B, S).contiguous()
    ring = alloc_cache(cfg, B, C, device=cuda)
    model.prefill(toks, pos, pos, ring)
    NB = C // ps
    table = (np.random.default_rng(2).permutation(B * NB) + 1).reshape(B, NB)
    paged = alloc_paged_cache(cfg, B, C, ps, 1 + B * NB, device=cuda)
    pack_paged_cache(paged, ring, table.astype(np.int32))
    logical = np.broadcast_to(np.arange(NB, dtype=np.int32), (B, NB)).copy()
    paged["blocks"] = blocks_arrays(table, logical, np.full(B, NB, np.int32), device=cuda)
    return {"ring": ring, "paged": paged}, S


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def _fused_and_separate(model, cache, S):
    """The fused path's and the separate path's (logits, EAT, next logits,
    next logits) from copies of ``cache``, and the fused step's launches
    (paged, entropy, flash per variant)."""
    B = cache["pos"].shape[0]
    dev = cache["pos"].device
    tok = torch.full((B, 1), 7, dtype=torch.long, device=dev)
    p1 = torch.full((B, 1), S, dtype=torch.int32, device=dev)
    pos_all = p1 + torch.arange(3, dtype=torch.int32, device=dev)[None]
    pp = pos_all[:, 1:].contiguous()
    probe = torch.tensor([PROBE] * B, device=dev)
    fc, sc = _clone(cache), _clone(cache)
    before = (pa.paged_attention_cuda.launches, ep.entropy_probe_cuda.launches,
              dict(fa.flash_attention_cuda.variant_launches))
    f = list(model.decode_and_probe(tok, pos_all, pos_all, fc, probe))
    launched = (pa.paged_attention_cuda.launches - before[0],
                ep.entropy_probe_cuda.launches - before[1],
                {k: v - before[2][k] for k, v in fa.flash_attention_cuda.variant_launches.items()})
    s = [model.decode_step(tok, p1, p1, sc),
         model.probe_entropy(probe, pp, pp, sc)]
    for k in (1, 2):
        pk = p1 + k
        f.append(model.decode_step(tok, pk, pk, fc))
        s.append(model.decode_step(tok, pk, pk, sc))
    assert int(fc["cur"]) == int(sc["cur"]) == S + 3
    return f, s, launched


def _within_bars(f, s):
    for i, (a, b) in enumerate(zip(f, s)):
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        if i == 1:
            assert (a - b).abs().max().item() <= 6e-2
            continue
        assert ((a - b).norm() / b.norm()).item() <= 3e-2
        assert ((a - b).abs().max() / b.abs().max()).item() <= 3e-2


def test_dense_fused_step_matches_separate_and_paged_equals_ring(cuda):
    model = _model(cuda, "qwen3-1.7b", n_kv_heads=1)
    caches, S = _caches(model, cuda)
    outs = {}
    for kind, cache in caches.items():
        f, s, (paged, ent, flash) = _fused_and_separate(model, cache, S)
        _within_bars(f, s)
        assert (paged, ent) == (model.cfg.n_layers, 1)
        assert sum(flash.values()) == 0
        outs[kind] = f
    for a, b in zip(outs["ring"], outs["paged"]):
        assert torch.equal(a, b)


def test_mla_fused_step_runs_the_mla_kernel_at_m3(cuda):
    model = _model(cuda, "deepseek-v2-236b")
    caches, S = _caches(model, cuda)
    f, s, (paged, ent, flash) = _fused_and_separate(model, caches["ring"], S)
    _within_bars(f, s)
    assert flash == {"mma": 0, "mla": model.cfg.n_layers, "wide": 0, "scalar": 0}
    assert (paged, ent) == (0, 1)


@pytest.mark.parametrize("impl", ["gather", "auto"])
def test_hybrid_fused_step_is_the_separate_step(cuda, impl):
    """A reduced bf16 hybrid's fused step falls back to the separate step:
    bitwise, with its probe read by flash (``gather``) or by the paged
    kernel (``auto``)."""
    model = _model(cuda, "zamba2-2.7b")
    model.paged_attn_impl = impl
    caches, S = _caches(model, cuda)
    f, s, _ = _fused_and_separate(model, caches["ring"], S)
    for a, b in zip(f, s):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_probe_writes_past_mapped_pages_kernel_vs_plain(cuda, dtype):
    """Row 0 maps logical blocks 0..2 (slots 0..47), row 1 all four: the
    fused step at slot 47 puts its probe's K/V (slots 48, 49) in the trash
    page.  The paged kernel and its plain version read the same cache; row
    0's block 3 is then mapped to a fresh page for two decode steps."""
    from repro_torch.serving.cache import (alloc_cache, alloc_paged_cache,
                                           blocks_arrays, pack_paged_cache)

    model = _model(cuda, "qwen3-1.7b", n_kv_heads=1, dtype=dtype)
    cfg, B, S, C, ps = model.cfg, 2, 47, 64, 16
    toks = torch.randint(4, cfg.vocab, (B, S), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    pos = torch.arange(S, dtype=torch.int32, device=cuda).expand(B, S).contiguous()
    ring = alloc_cache(cfg, B, C, device=cuda)
    model.prefill(toks, pos, pos, ring)
    perm = (np.random.default_rng(2).permutation(8) + 1).astype(np.int32)
    table = np.zeros((B, C // ps), np.int32)
    table[0, :3], table[1] = perm[:3], perm[3:7]

    def blocks(t):
        logical = np.where(t != 0, np.arange(t.shape[1], dtype=np.int32)[None], 0)
        return blocks_arrays(t, logical.astype(np.int32),
                             (t != 0).sum(1).astype(np.int32), device=cuda)

    base = alloc_paged_cache(cfg, B, C, ps, 9, device=cuda)
    pack_paged_cache(base, ring, table)
    base["blocks"] = blocks(table)
    tok = torch.full((B, 1), 7, dtype=torch.long, device=cuda)
    p1 = torch.full((B, 1), S, dtype=torch.int32, device=cuda)
    pos_all = p1 + torch.arange(3, dtype=torch.int32, device=cuda)[None]
    probe = torch.tensor([PROBE] * B, device=cuda)
    outs = {}
    for impl in ("auto", "plain"):
        model.paged_attn_impl = impl
        cache, t = _clone(base), table.copy()
        n = pa.paged_attention_cuda.launches
        out = list(model.decode_and_probe(tok, pos_all, pos_all, cache, probe))
        assert pa.paged_attention_cuda.launches - n == (cfg.n_layers if impl == "auto" else 0)
        t[0, 3] = perm[7]
        cache["page_table"].copy_(torch.from_numpy(t))
        cache["blocks"] = blocks(t)
        for k in (1, 2):
            out.append(model.decode_step(tok, p1 + k, p1 + k, cache))
        outs[impl] = out
    if dtype == "float32":
        for a, b in zip(outs["auto"], outs["plain"]):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    else:
        _within_bars(outs["auto"], outs["plain"])


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def test_serve_step_program_graph_equals_eager(cuda):
    from repro_torch.serving.executor import ServeStepConfig, build_serve_step_program
    from repro_torch.serving.sampler import SamplerConfig

    model = _model(cuda, "qwen3-1.7b", n_kv_heads=1)
    caches, S = _caches(model, cuda)
    base = caches["paged"]
    step, mon0 = build_serve_step_program(
        model, ServeStepConfig(sampler=SamplerConfig(greedy=True), fused_probe=True), base)
    B = base["pos"].shape[0]
    tok0 = torch.full((B, 1), 7, dtype=torch.long, device=cuda)
    pos0 = torch.full((B, 1), S, dtype=torch.int32, device=cuda)

    def run(cache):
        t, p, mon, out = tok0, pos0, mon0, []
        for _ in range(8):
            nxt, mon, stop = step(cache, t, p, mon, None)
            out.append(nxt)
            t, p = nxt[:, None], p + 1
        return [torch.stack(out, 1), stop] + _leaves(mon)

    eager_c = _clone(base)
    eager = run(eager_c)
    graph_c = _clone(base)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(graph_c)
    torch.cuda.current_stream().wait_stream(side)

    def restore():
        for a, b in zip(_leaves(graph_c), _leaves(base)):
            a.copy_(b)

    restore()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = run(graph_c)
    for _ in ("cold", "warm"):
        restore()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(g_out, eager))
        assert all(torch.equal(a, b) for a, b in zip(_leaves(graph_c), _leaves(eager_c)))
    assert math.isfinite(float(eager[-1].float().sum()))
