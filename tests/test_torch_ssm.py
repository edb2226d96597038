"""The port's Mamba2 slice against the JAX reference on the CPU.

* The plain ``ssd_scan`` against JAX ``ssd_scan_pallas`` (interpret mode)
  and ``ssd_chunked`` on ``tests/test_ssm.py``'s sweep shapes (G < nh, S not
  a multiple of the chunk, chunk 4), and with a nonzero ``h0`` against
  ``ssd_chunked``: 2e-5 in float32, the reference's own bar.
* ``ssm_forward`` / ``ssm_step`` on ``tiny-ssm`` params through
  ``from_jax``: outputs and states within 1e-5 (float32).
* ``Model.prefill`` / ``decode_step`` / ``probe_entropy`` against JAX with a
  40-token prompt (> 16, so the prefill runs the scan): 1e-4 on hidden
  states, logits and entropies (a full float32 forward), as the dense tests.
* What JAX gets from purity and the port keeps by hand: a probe and a
  rollout leave every state leaf bitwise unchanged, and so does a
  ``decode_chunk`` for an inactive row.
* The ``tiny-ssm`` ring serve (greedy, prompts left-padded to 40 tokens)
  gives the JAX engine's tokens, exit steps and reasons, forced answers and
  EAT evaluation counts exactly; the traced EMA variance agrees within
  float32 tolerance (atol 1e-5, rtol 1e-4).
* A paged cache is refused for an SSM; ``from_jax`` keeps each leaf's
  dtype (``dt_bias``, ``A_log``, ``D`` float32 under a bfloat16 config).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.core.eat import make_probe as jprobe
from repro.core.monitor import ReasoningMonitor as JMonitor
from repro.core.stopping import EATStopper as JStopper
from repro.data.synthetic import ChainTask, Tokens
from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.serving.cache import CacheConfig as JCache
from repro.serving.cache import alloc_cache as jalloc
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReasoningEngine as JEngine
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch.configs.base import get_config
from repro_torch.core.eat import make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model, init_params
from repro_torch.params import from_jax
from repro_torch.serving.cache import (
    CacheConfig,
    alloc_cache,
    alloc_paged_cache,
    freeze_inactive_rows,
)
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.sampler import SamplerConfig

from _torch_threads import _one_thread  # noqa: F401


ROOT = os.path.join(os.path.dirname(__file__), "..")

SSD_SWEEP = [
    # B, S, nh, hp, G, N, chunk (tests/test_ssm.py)
    (1, 16, 2, 8, 1, 8, 8),
    (2, 37, 4, 8, 2, 16, 16),
    (2, 64, 8, 16, 1, 32, 32),
    (1, 20, 6, 8, 3, 8, 4),
]
WIDTH = 40          # serve prompts left-padded past the m > 16 scan switch


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def close(a, b, tol):
    np.testing.assert_allclose(a.detach().float().numpy(),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


def scan_inputs(case, seed=3, h0=False):
    B, S, nh, hp, G, N, _ = case
    rng = np.random.default_rng(seed)
    u = (rng.normal(size=(B, S, nh, hp)) * 0.3).astype(np.float32)
    logd = (-np.abs(rng.normal(size=(B, S, nh))) * 0.2).astype(np.float32)
    Bm = (rng.normal(size=(B, S, G, N)) * 0.4).astype(np.float32)
    Cm = (rng.normal(size=(B, S, G, N)) * 0.4).astype(np.float32)
    out = [u, logd, Bm, Cm]
    if h0:
        out.append((rng.normal(size=(B, nh, N, hp)) * 0.2).astype(np.float32))
    return out


# ------------------------------------------------------------------ the scan


@pytest.mark.parametrize("case", SSD_SWEEP)
def test_plain_scan_matches_pallas_interpret_and_chunked(case):
    u, logd, Bm, Cm = scan_inputs(case)
    chunk = case[-1]
    y, h = ssd_scan_plain(t(u), t(logd), t(Bm), t(Cm), chunk=chunk)
    yp, hp_ = ssd_scan_pallas(jnp.asarray(u), jnp.asarray(logd), jnp.asarray(Bm),
                              jnp.asarray(Cm), chunk=chunk, interpret=True)
    yc, hc = jssm.ssd_chunked(jnp.asarray(u), jnp.asarray(logd), jnp.asarray(Bm),
                              jnp.asarray(Cm), chunk)
    for ref_y, ref_h in ((yp, hp_), (yc, hc)):
        close(y, ref_y, 2e-5)
        close(h, ref_h, 2e-5)
    # the dispatcher takes the plain version for CPU tensors
    y2, h2 = ssd_scan(t(u), t(logd), t(Bm), t(Cm), chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("case", SSD_SWEEP)
def test_plain_scan_with_initial_state_matches_chunked(case):
    u, logd, Bm, Cm, h0 = scan_inputs(case, seed=5, h0=True)
    chunk = case[-1]
    y, h = ssd_scan_plain(t(u), t(logd), t(Bm), t(Cm), chunk=chunk, h0=t(h0))
    yc, hc = jssm.ssd_chunked(jnp.asarray(u), jnp.asarray(logd), jnp.asarray(Bm),
                              jnp.asarray(Cm), chunk, h0=jnp.asarray(h0))
    close(y, yc, 2e-5)
    close(h, hc, 2e-5)


def test_plain_scan_survives_underflowing_decays():
    """Decays as steep as mamba2-2.7b's last heads (A = -80, dt ~ 0.1):
    exp(cs) underflows to 0 over a chunk, exp(cs_t - cs_s) must not."""
    case = (1, 48, 2, 8, 1, 8, 16)
    u, logd, Bm, Cm, h0 = scan_inputs(case, h0=True)
    logd = np.full_like(logd, -8.0)
    y, h = ssd_scan_plain(t(u), t(logd), t(Bm), t(Cm), chunk=16, h0=t(h0))
    yc, hc = jssm.ssd_chunked(jnp.asarray(u), jnp.asarray(logd), jnp.asarray(Bm),
                              jnp.asarray(Cm), 16, h0=jnp.asarray(h0))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    close(y, yc, 2e-5)
    close(h, hc, 2e-5)


def test_cuda_impl_refuses_cpu_tensors():
    u, logd, Bm, Cm = (t(a) for a in scan_inputs(SSD_SWEEP[0]))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(u, logd, Bm, Cm, chunk=8, impl="cuda")


# ------------------------------------------------------------------ the block


@pytest.fixture(scope="module")
def tiny():
    jcfg = jget("tiny-ssm")
    jmodel = JModel(jcfg, attn_impl="xla")
    params = jmodel.init(jax.random.PRNGKey(11))
    cfg = get_config("tiny-ssm")
    model = Model(cfg, from_jax(jax.tree_util.tree_map(np.asarray, params),
                                cfg, "cpu"))
    return jmodel, params, model


def _layer0(params, model):
    jp = jax.tree_util.tree_map(lambda a: a[0], params["stack"]["layers"]["ssm"])
    tp = {k: v for k, v in model.layers[0]["ssm"].items()}
    return jp, tp


def _state_close(ts, js, tol):
    close(ts["ssm"], js["ssm"], tol)
    close(ts["conv"]["x"], js["conv"]["x"], tol)
    close(ts["conv"]["bc"], js["conv"]["bc"], tol)


def test_ssm_forward_and_step_match_jax(tiny):
    jmodel, params, model = tiny
    cfg, jcfg = model.cfg, jmodel.cfg
    jp, tp = _layer0(params, model)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 37, cfg.d_model)) * 0.5).astype(np.float32)
    valid = np.ones((2, 37), bool)
    valid[1, :9] = False
    jforward = jax.jit(jssm.ssm_forward, static_argnums=2)
    jstep = jax.jit(jssm.ssm_step, static_argnums=2)
    jy, jst = jforward(jp, jnp.asarray(x), jcfg, valid=jnp.asarray(valid))
    ty, tst = tssm.ssm_forward(tp, t(x), cfg, valid=torch.from_numpy(valid))
    close(ty, jy, 1e-5)
    _state_close(tst, jst, 1e-5)
    # a continuation from that state: conv tails and h0 both nonzero
    x2 = (rng.normal(size=(2, 21, cfg.d_model)) * 0.5).astype(np.float32)
    jy2, jst2 = jforward(jp, jnp.asarray(x2), jcfg, conv_tail=jst["conv"],
                         h0=jst["ssm"])
    ty2, tst2 = tssm.ssm_forward(tp, t(x2), cfg, conv_tail=tst["conv"], h0=tst["ssm"])
    close(ty2, jy2, 1e-5)
    _state_close(tst2, jst2, 1e-5)
    for m in (1, 2):
        xs = x2[:, :m]
        jy3, jst3 = jstep(jp, jnp.asarray(xs), jcfg, jst2)
        ty3, tst3 = tssm.ssm_step(tp, t(xs), cfg, tst2)
        close(ty3, jy3, 1e-5)
        _state_close(tst3, jst3, 1e-5)


def _prompt(vocab, S=WIDTH, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, vocab, size=(2, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    pos[1, :7] = -1                          # row 1 left-padded by 7
    pos[1, 7:] = np.arange(S - 7)
    toks[1, :7] = 0
    return toks, pos


def test_prefill_decode_probe_match_jax(tiny):
    jmodel, params, model = tiny
    toks, pos = _prompt(model.cfg.vocab)
    jcache, tcache = jalloc(jmodel.cfg, 2, 64), alloc_cache(model.cfg, 2, 64, device="cpu")
    jh, jcache = jmodel.prefill(params, jnp.asarray(toks), jnp.asarray(pos),
                                jnp.asarray(pos), jcache)
    th = model.prefill(torch.from_numpy(toks).long(), torch.from_numpy(pos),
                       torch.from_numpy(pos), tcache)
    close(th, jh, 1e-4)
    assert tcache["cur"] == int(jcache["cur"]) == WIDTH
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    seg = jcache["layers"]["seg"]
    for li, st in enumerate(tcache["layers"]):
        _state_close(st, jax.tree_util.tree_map(lambda a: a[li], seg), 1e-4)

    nxt = np.array([[7], [9]], np.int32)
    p1 = np.array([[WIDTH], [WIDTH - 7]], np.int32)
    jl, jcache = jmodel.decode_step(params, jnp.asarray(nxt), jnp.asarray(p1),
                                    jnp.asarray(p1), jcache)
    tl = model.decode_step(torch.from_numpy(nxt).long(), torch.from_numpy(p1),
                           torch.from_numpy(p1), tcache)
    close(tl, jl, 1e-4)

    probe = np.array([[1, 6]] * 2, np.int32)
    pp = p1 + 1 + np.arange(2, dtype=np.int32)[None]
    je = jmodel.probe_entropy(params, jnp.asarray(probe), jnp.asarray(pp),
                              jnp.asarray(pp), jcache, entropy_impl="xla")
    te = model.probe_entropy(torch.from_numpy(probe).long(), torch.from_numpy(pp),
                             torch.from_numpy(pp), tcache)
    close(te, je, 1e-4)


# ------------------------------------------------------------ purity by hand


def _leaves(cache):
    out = [cache["pos"].clone()]
    for st in cache["layers"]:
        out += [st["ssm"].clone(), st["conv"]["x"].clone(), st["conv"]["bc"].clone()]
    return out


def _assert_same(before, after):
    assert len(before) == len(after)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def _engine(model, *, delta=0.0, kind="ring", budget=16, chunk=4):
    ecfg = EngineConfig(max_reasoning_tokens=budget, capacity=256, chunk_len=chunk,
                        sampler=SamplerConfig(greedy=True),
                        cache=CacheConfig(kind=kind))
    mon = ReasoningMonitor(stopper=EATStopper(delta=delta), probe=make_probe(1, (6,)),
                           schedule="every_n", every_n=2, min_evals=1)
    return ReasoningEngine(model, ecfg, mon)


def _mid_serve(model, B=3):
    eng = _engine(model)
    toks = np.random.default_rng(2).integers(4, model.cfg.vocab, size=(B, 24))
    ss = eng._serve_setup(toks, np.full(B, 24), None, batch_size=B,
                          max_tokens=16, chunk_len=4)
    return eng, eng.executor.decode_chunk(ss.state, 16, 4)


def test_probe_and_rollout_leave_the_state_unchanged(tiny):
    _, _, model = tiny
    eng, state = _mid_serve(model)
    before = _leaves(state.cache)
    cur = state.cache["cur"]
    e1 = eng.executor.probe(state.cache, state.next_pos)
    _assert_same(before, _leaves(state.cache))
    toks1, _ = eng.force_answer(state, 4, greedy=True)
    _assert_same(before, _leaves(state.cache))
    assert state.cache["cur"] == cur
    assert torch.equal(eng.executor.probe(state.cache, state.next_pos), e1)
    toks2, _ = eng.force_answer(state, 4, greedy=True)
    assert torch.equal(toks1, toks2)


def test_inactive_row_state_is_frozen_across_a_chunk(tiny):
    _, _, model = tiny
    eng, state = _mid_serve(model)
    state.active[1] = False
    before = _leaves(state.cache)
    state = eng.executor.decode_chunk(state, 16, 4)
    after = _leaves(state.cache)
    for a, b in zip(before[1:], after[1:]):
        assert torch.equal(a[1], b[1])             # the inactive row: bitwise
        assert not torch.equal(a[0], b[0])          # an active row moved on


def test_freeze_keeps_active_rows_bitwise():
    cfg = get_config("tiny-ssm")
    rng = np.random.default_rng(4)
    old = alloc_cache(cfg, 3, 8, device="cpu")["layers"]
    new = [{"ssm": t(rng.normal(size=st["ssm"].shape)),
            "conv": {k: t(rng.normal(size=v.shape)) for k, v in st["conv"].items()}}
           for st in old]
    cache = {"layers": list(new)}
    freeze_inactive_rows(cache, old, torch.tensor([True, False, True]))
    for f, n, o in zip(cache["layers"], new, old):
        for get in (lambda e: e["ssm"], lambda e: e["conv"]["x"],
                    lambda e: e["conv"]["bc"]):
            assert torch.equal(get(f)[[0, 2]], get(n)[[0, 2]])
            assert torch.equal(get(f)[1], get(o)[1])


# ---------------------------------------------------------------- the serve


@pytest.fixture(scope="module")
def workload(tiny):
    jmodel, params, model = tiny
    batch = ChainTask().serve_batch(np.random.default_rng(7), 6)
    pad = WIDTH - batch["prompts"].shape[1]
    batch["prompts"] = np.pad(batch["prompts"], ((0, 0), (pad, 0)),
                              constant_values=Tokens.PAD)
    return jmodel, params, model, batch


def _jax_serve(jmodel, params, batch, delta):
    ecfg = JEngineConfig(
        max_reasoning_tokens=24, capacity=512, pad_id=Tokens.PAD,
        end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
        eos_id=Tokens.EOS, chunk_len=8, sampler=JSampler(greedy=True),
        cache=JCache(kind="ring"))
    mon = JMonitor(stopper=JStopper(alpha=0.2, delta=delta),
                   probe=jprobe(Tokens.END_THINK, (Tokens.ANS,)),
                   schedule="every_n", every_n=4, min_evals=1)
    return JEngine(jmodel, params, ecfg, mon).serve(
        batch["prompts"], batch["prompt_len"], jax.random.PRNGKey(0),
        batch_size=4, max_tokens=24, answer_len=4, record_trace=True)


def _serve(model, batch, delta, kind="ring"):
    ecfg = EngineConfig(
        max_reasoning_tokens=24, capacity=512, pad_id=Tokens.PAD,
        end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
        eos_id=Tokens.EOS, chunk_len=8, sampler=SamplerConfig(greedy=True),
        cache=CacheConfig(kind=kind))
    mon = ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=delta),
                           probe=make_probe(Tokens.END_THINK, (Tokens.ANS,)),
                           schedule="every_n", every_n=4, min_evals=1)
    return ReasoningEngine(model, ecfg, mon).serve(
        batch["prompts"], batch["prompt_len"], None, batch_size=4,
        max_tokens=24, answer_len=4, record_trace=True)


@pytest.mark.parametrize("delta", [1e9, 0.2])
def test_ring_serve_matches_jax(workload, delta):
    jmodel, params, model, batch = workload
    ref = _jax_serve(jmodel, params, batch, delta)
    out = _serve(model, batch, delta)
    assert len(out) == len(ref) == 6
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o["reasoning_tokens"],
                                      np.asarray(r["reasoning_tokens"]))
        assert o["n_reasoning"] == r["n_reasoning"]
        assert o["exit_reason"] == r["exit_reason"]
        assert o["ended_think"] == r["ended_think"]
        np.testing.assert_array_equal(o["answer_tokens"],
                                      np.asarray(r["answer_tokens"]))
        assert [e[:2] for e in o["eat_trace"]] == [e[:2] for e in r["eat_trace"]]
        np.testing.assert_allclose([e[2] for e in o["eat_trace"]],
                                   [e[2] for e in r["eat_trace"]],
                                   atol=1e-5, rtol=1e-4)
    if delta == 1e9:
        assert {o["exit_reason"] for o in out} == {"eat"}
    # 6 requests through 4 slots: the recycled slots ran admissions
    assert len({o["slot"] for o in out}) < len(out)


def test_paged_cache_is_refused_for_ssm(workload):
    _, _, model, batch = workload
    with pytest.raises(ValueError, match="no KV capacity axis"):
        alloc_paged_cache(model.cfg, 2, 32, 16, 5, device="cpu")
    with pytest.raises(ValueError, match="no KV capacity axis"):
        _serve(model, batch, 1e9, kind="paged")


def test_from_jax_keeps_float32_ssm_leaves_under_bf16():
    jcfg = dataclasses.replace(jget("tiny-ssm"), dtype="bfloat16")
    params = JModel(jcfg).init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("tiny-ssm"), dtype="bfloat16")
    tp = from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    ssm = tp["layers"][1]["ssm"]
    for name in ("dt_bias", "A_log", "D"):
        assert ssm[name].dtype == torch.float32, name
        np.testing.assert_array_equal(
            ssm[name].numpy(), np.asarray(params["stack"]["layers"]["ssm"][name][1]))
    for name in ("w_x", "out_proj", "conv_x_w", "norm_w"):
        assert ssm[name].dtype == torch.bfloat16, name
    assert tp["layers"][0]["norm"].dtype == tp["embed"]["lm_head"].dtype == torch.bfloat16


def test_init_params_has_the_reference_layout():
    cfg = get_config("tiny-ssm")
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = JModel(jget("tiny-ssm")).init(jax.random.PRNGKey(0))
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["stack"]["layers"])
    tl = tp["layers"][0]
    assert set(tl) == set(jl) and set(tl["ssm"]) == set(jl["ssm"])
    for k, v in jl["ssm"].items():
        assert tuple(tl["ssm"][k].shape) == v.shape, k
        assert str(tl["ssm"][k].dtype).split(".")[-1] == str(v.dtype), k
    np.testing.assert_allclose(tl["ssm"]["A_log"].numpy(), np.asarray(jl["ssm"]["A_log"]))
    assert len(tp["layers"]) == cfg.n_layers


def test_serve_cli_tiny_ssm_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
            "--arch", "tiny-ssm", "--requests", "6", "--batch", "2",
            "--budget", "16"]
    r = subprocess.run(base + ["--cache", "ring"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "served 6 requests through 2 slots on cpu" in r.stdout, r.stdout
    r = subprocess.run(base + ["--cache", "paged"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode != 0 and "use --cache ring" in r.stderr
