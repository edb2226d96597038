"""The port's evaluation path (paper App. H) against the JAX reference, on
the CPU: the stoppers, ``entropy_of_logits``, ``reason_with_trace``,
``rollout_answers``, ``eval_eat_now``, the unmonitored step and the
per-token loop, and the trace harness's replays.

Same params (``repro_torch.params.from_jax``), same numpy-seeded inputs.
JAX's threefry and torch's Philox draw different streams, so the engines
run ``SamplerConfig(greedy=True, top_k=1)``: the chain is greedy and every
sampled rollout draws from a single token, whatever the generator.
Tolerances: integer states, stop masks, tokens, answers and record counts
exact; float states, EAT, the EMA variance and the confidence 1e-5.

The reference's ``reason_with_trace`` keeps ``rng = state.rng`` and then
hands ``state`` to ``decode_chunk``, which DONATES it: with ``rollout_k >
0`` the later ``jax.random.split(rng)`` reads a deleted buffer ("Buffer has
been deleted or donated").  The JAX engines here wrap their executor's
``decode_chunk`` so that each chunk receives a copy of the state's key
(``_jax_engine``), which changes no value and leaves the JAX package as it
is.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.core import stopping as jstop
from repro.core.eat import entropy_of_logits as jentropy
from repro.core.eat import make_probe as jprobe
from repro.core.monitor import ReasoningMonitor as JMonitor
from repro.data.synthetic import ChainTask, Tokens
from repro.models import Model as JModel
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ReasoningEngine as JEngine
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch.configs.base import get_config
from repro_torch.core import stopping as tstop
from repro_torch.core.eat import entropy_of_logits, make_probe
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.kernels.entropy_probe.ops import next_token_entropy_plain
from repro_torch.models.model import Model
from repro_torch.params import from_jax
from repro_torch.serving.engine import EngineConfig, ReasoningEngine
from repro_torch.serving.sampler import SamplerConfig

from _torch_threads import _one_thread  # noqa: F401


ROOT = os.path.join(os.path.dirname(__file__), "..")
BUDGET = 24


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny():
    jmodel = JModel(jget("tiny"), attn_impl="xla")
    params = jmodel.init(jax.random.PRNGKey(11))
    cfg = get_config("tiny")
    return jmodel, params, Model(cfg, from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg, "cpu"))


@pytest.fixture(scope="module")
def batch():
    """4 prompts; under the newline schedule the greedy chains of rows 0
    and 2 emit the newline id."""
    return ChainTask().serve_batch(np.random.default_rng(7), 4)


ECFG = dict(max_reasoning_tokens=BUDGET, capacity=256, pad_id=Tokens.PAD,
            end_think_id=Tokens.END_THINK, newline_id=Tokens.NEWLINE,
            eos_id=Tokens.EOS, chunk_len=8)
PROBE = (Tokens.END_THINK, (Tokens.ANS,))


def _mon(schedule):
    return dict(schedule=schedule, newline_id=Tokens.NEWLINE, every_n=4,
                min_evals=2)


def _jax_engine(jmodel, params, *, delta=1e-3, schedule="every_n"):
    eng = JEngine(jmodel, params,
                  JEngineConfig(sampler=JSampler(greedy=True, top_k=1), **ECFG),
                  JMonitor(stopper=jstop.EATStopper(alpha=0.2, delta=delta),
                           probe=jprobe(*PROBE), **_mon(schedule)))
    chunk = eng.executor.decode_chunk
    # a copy of the key into each (donating) chunk: see the module docstring
    eng.executor.decode_chunk = lambda p, st, *a, **k: chunk(
        p, st._replace(rng=jnp.array(st.rng)), *a, **k)
    return eng


def _engine(model, *, delta=1e-3, schedule="every_n", sampler=None):
    return ReasoningEngine(
        model, EngineConfig(sampler=sampler or SamplerConfig(greedy=True, top_k=1),
                            **ECFG),
        ReasoningMonitor(stopper=tstop.EATStopper(alpha=0.2, delta=delta),
                         probe=make_probe(*PROBE), **_mon(schedule)))


@pytest.fixture(scope="module")
def engines(tiny):
    """(JAX engine, port engine) per (schedule, delta), built once: the
    JAX engine's compiled programs are kept across tests."""
    jmodel, params, model = tiny
    made = {}

    def get(schedule="every_n", delta=1e-3):
        if (schedule, delta) not in made:
            made[schedule, delta] = (
                _jax_engine(jmodel, params, delta=delta, schedule=schedule),
                _engine(model, delta=delta, schedule=schedule))
        return made[schedule, delta]

    return get


def _starts(jeng, eng, b, seed=6):
    return (jeng.start(jnp.asarray(b["prompts"]), jnp.asarray(b["prompt_len"]),
                       jax.random.PRNGKey(seed)),
            eng.start(b["prompts"], b["prompt_len"],
                      torch.Generator().manual_seed(seed)))


# --------------------------------------------------------------- stoppers


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    if isinstance(x, tuple):
        return [a for v in x for a in _leaves(v)]
    return [np.asarray(x)]


def _same_state(js, ts):
    jl, tl = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)], _leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(b, a)
            assert b.dtype.itemsize == a.dtype.itemsize


def _signals(name, rng, T, B):
    if name == "budget":
        return rng.integers(0, 6, (T, B)).astype(np.int32)
    if name == "ua":
        ans = rng.integers(0, 3, (T, B, 4)).astype(np.int32)
        ans[:, 0] = 1                      # row 0: one answer, #UA = 1
        return ans
    if name == "confidence":
        return rng.uniform(0.2, 0.9, (T, B)).astype(np.float32)
    if name == "giveup":
        # a noisy start that settles, then noisy again: the stall streak
        # grows, resets on a new low, and reaches the patience
        x = rng.normal(2.0, 1.0, (T, B))
        x[6:9] = 2.0 + rng.normal(0, 0.01, (3, B))
        return x.astype(np.float32)
    return rng.normal(2.0, 0.3, (T, B)).astype(np.float32)


STOPPERS = {
    "eat": lambda m: m.EATStopper(alpha=0.2, delta=0.3),
    "budget": lambda m: m.TokenBudgetStopper(budget=20),
    "ua": lambda m: m.UniqueAnswerStopper(k=4, max_unique=1),
    "confidence": lambda m: m.ConfidenceStopper(alpha=0.2, delta=0.05),
    "giveup": lambda m: m.GiveUpStopper(alpha=0.2, ceiling=0.05, patience=3,
                                        min_evals=2, improve_tol=0.05),
}


@pytest.mark.parametrize("name", list(STOPPERS))
def test_stoppers_match_jax(name):
    """16 updates of 5 rows, each with a seeded ``active`` mask: the states
    (ints exact, floats 1e-5) and ``should_stop`` (exact) after each."""
    T, B = 16, 5
    rng = np.random.default_rng(3)
    sig = _signals(name, rng, T, B)
    act = rng.random((T, B)) < 0.75
    js, ts = STOPPERS[name](jstop), STOPPERS[name](tstop)
    jst, tst = js.init(B), ts.init(B, "cpu")
    _same_state(jst, tst)
    stops, streaks = [], []
    for i in range(T):
        jst = js.update(jst, jnp.asarray(sig[i]), jnp.asarray(act[i]))
        tst = ts.update(tst, torch.from_numpy(sig[i]), torch.from_numpy(act[i]))
        _same_state(jst, tst)
        stop = np.asarray(js.should_stop(jst))
        np.testing.assert_array_equal(ts.should_stop(tst).numpy(), stop)
        stops.append(stop)
        if name == "giveup":
            streaks.append(np.asarray(jst.stall_streak))
    assert np.any(stops) and not np.all(stops)
    if name == "giveup":
        s = np.stack(streaks)
        assert ((s[:-1] > 0) & (s[1:] == 0)).any()      # a reset
        assert s.max() >= 3                              # the patience


@pytest.mark.parametrize("masked", [False, True])
def test_confidence_from_logprobs_matches_jax(masked):
    rng = np.random.default_rng(4)
    lps = np.log(rng.uniform(0.05, 1.0, (6, 5))).astype(np.float32)
    mask = (rng.random((6, 5)) < 0.6).astype(np.float32) if masked else None
    if mask is not None:
        mask[0] = 0.0                      # a row with no token kept
    want = np.asarray(jstop.confidence_from_logprobs(
        jnp.asarray(lps), None if mask is None else jnp.asarray(mask)))
    got = tstop.confidence_from_logprobs(
        torch.from_numpy(lps), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_entropy_of_logits_matches_jax_and_the_plain_probe():
    """A padded table (vocab 300 of 384 columns): ``entropy_of_logits`` of
    ``h · W`` against the JAX one and against the port's plain
    ``entropy_probe`` (the kernel's comparator), 1e-5."""
    rng = np.random.default_rng(5)
    h = rng.normal(size=(6, 32)).astype(np.float32)
    w = rng.normal(size=(32, 384)).astype(np.float32) * 0.3
    logits = h @ w
    got = entropy_of_logits(torch.from_numpy(logits), 300)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jentropy(jnp.asarray(logits), 300)),
                               rtol=0, atol=1e-5)
    plain = next_token_entropy_plain(torch.from_numpy(h), torch.from_numpy(w), 300)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-5)
    full = entropy_of_logits(torch.from_numpy(logits))
    assert (full > got).all()              # the padded columns were dropped


# ------------------------------------------------------------ the engine


def _same_trace(jtr, ttr):
    assert len(jtr) == len(ttr) >= 1
    for a, b in zip(jtr, ttr):
        assert list(a) == list(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            if k in ("eat", "ema_var", "confidence"):
                np.testing.assert_allclose(y, x, rtol=0, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(y, x, err_msg=k)


@pytest.mark.parametrize("schedule", ["every_n", "newline"])
@pytest.mark.parametrize("k", [0, 3])
def test_reason_with_trace_matches_jax(engines, batch, schedule, k):
    """``n_tokens``, ``due``, ``rollouts``, ``answers`` and the final
    ``out_tokens`` exact; ``eat``, ``ema_var``, ``confidence`` 1e-5."""
    jeng, eng = engines(schedule)
    jst, tst = _starts(jeng, eng, batch)
    kw = dict(max_tokens=BUDGET, rollout_k=k, rollout_len=4,
              answer_extract=ChainTask.extract_answer, confidence_len=5)
    jst, jtr = jeng.reason_with_trace(jst, **kw)
    tst, ttr = eng.reason_with_trace(tst, **kw)
    _same_trace(jtr, ttr)
    np.testing.assert_array_equal(tst.out_tokens.numpy(), np.asarray(jst.out_tokens))
    if k:
        assert ttr[0]["rollouts"].shape == (k, 4, 4)


def test_rollout_answers_and_eval_eat_now_match_jax(engines, batch):
    """On a ``start`` state: K = 3 rollouts of 4 tokens exact, EAT 1e-5;
    neither moves the state (a second call gives the same)."""
    jeng, eng = engines()
    jst, tst = _starts(jeng, eng, batch)
    want = np.asarray(jeng.rollout_answers(jst, 3, 4, jax.random.PRNGKey(2)))
    gen = torch.Generator().manual_seed(2)
    got = eng.rollout_answers(tst, 3, 4, gen)
    assert got.shape == (3, 4, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(eng.rollout_answers(tst, 3, 4, gen).numpy(), want)
    eat = np.asarray(jeng.eval_eat_now(jst))
    np.testing.assert_allclose(eng.eval_eat_now(tst).numpy(), eat, rtol=0, atol=1e-5)
    np.testing.assert_allclose(eng.eval_eat_now(tst).numpy(), eat, rtol=0, atol=1e-5)


def test_decode_step_matches_jax_and_freezes_inactive_rows(engines, batch):
    """The unmonitored step on a state with rows 1 and 3 inactive: the
    active rows advance one token, the others emit PAD and stay."""
    jeng, eng = engines()
    jst, tst = _starts(jeng, eng, batch)
    mask = np.array([True, False, True, False])
    jst = jeng._decode_fn(jeng.params, jst._replace(active=jnp.asarray(mask)))
    tst = eng._decode_fn(tst._replace(active=torch.from_numpy(mask)))
    for name in ("n_reasoning", "last_token", "next_pos", "out_len", "out_tokens"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)), err_msg=name)
    assert int(tst.cache["cur"]) == int(jst.cache["cur"])
    np.testing.assert_array_equal(tst.n_reasoning.numpy(), [2, 1, 2, 1])
    assert int(tst.last_token[1]) == Tokens.PAD


@pytest.mark.parametrize("use_monitor", [True, False])
def test_reason_per_token_matches_jax(engines, batch, use_monitor):
    """The per-token loop (every row exits by EAT at its 2nd evaluation
    with the monitor, else at the budget): tokens, counts, exits and
    evaluation counts exact; the EMA state 1e-5."""
    jeng, eng = engines(delta=1e9)
    jst, tst = _starts(jeng, eng, batch)
    jst = jeng._reason_per_token(jst, max_tokens=BUDGET, use_monitor=use_monitor)
    tst = eng._reason_per_token(tst, max_tokens=BUDGET, use_monitor=use_monitor)
    for name in ("out_tokens", "n_reasoning", "active", "ended_think"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)), err_msg=name)
    _same_state(jst.monitor, tst.monitor)
    n = tst.n_reasoning.numpy()
    assert (n < BUDGET).all() if use_monitor else (n == BUDGET).all()


def test_sampled_trace_chain_does_not_depend_on_rollouts(tiny, batch):
    """Temperature 0.6, top-p 0.95: the chain (every record's tokens, due
    rows and EAT, and the final tokens) is the same with 0 and with 2
    rollouts per point, which draw from their own generator (by default a
    copy of the state's at the start; an explicit copy gives the same
    rollouts)."""
    eng = _engine(tiny[2], sampler=SamplerConfig(temperature=0.6, top_p=0.95))
    runs = []
    for k, own in ((0, False), (2, False), (2, True)):
        st = eng.start(batch["prompts"], batch["prompt_len"],
                       torch.Generator().manual_seed(9))
        rr = None
        if own:
            rr = torch.Generator()
            rr.set_state(st.rng.get_state())
        st, tr = eng.reason_with_trace(st, max_tokens=BUDGET, rollout_k=k,
                                       rollout_len=4, rollout_rng=rr)
        runs.append((st.out_tokens.numpy(), tr))
    (t0, tr0), (t1, tr1), (t2, tr2) = runs
    np.testing.assert_array_equal(t0, t1)
    assert len(tr0) == len(tr1) == len(tr2) >= 1
    for a, b, c in zip(tr0, tr1, tr2):
        for key in ("n_tokens", "due", "eat", "ema_var"):
            np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(b["rollouts"], c["rollouts"])
    assert not np.array_equal(np.stack([r["rollouts"] for r in tr1])[:, 0],
                              np.stack([r["rollouts"] for r in tr1])[:, 1])


# --------------------------------------------------------------- harness


@pytest.fixture(scope="module")
def harnesses():
    return _load("trace_harness"), _load("torch_trace_harness")


def _synthetic_trace(L=14, K=6, B=5):
    rng = np.random.default_rng(8)
    return {
        "answers_true": rng.integers(0, 3, B),
        "k": rng.integers(1, 4, B),
        "n_tokens": np.cumsum(rng.integers(1, 9, (L, B)), 0).astype(np.int32),
        "due": rng.random((L, B)) < 0.8,
        "eat": (2.0 + 0.3 * rng.normal(size=(L, B)) / np.arange(1, L + 1)[:, None]
                ).astype(np.float32),
        "answers": rng.integers(0, 3, (L, K, B)),
        "confidence": rng.uniform(0.3, 0.9, (L, B)).astype(np.float32),
    }


REPLAYS = {
    "ema": lambda h, tr: h.replay_ema_stop(tr, tr["eat"], 0.2, 0.3),
    "confidence": lambda h, tr: h.replay_ema_stop(tr, tr["confidence"], 0.2, 0.05,
                                                  min_evals=3),
    "budget": lambda h, tr: h.replay_token_budget(tr, 40),
    "ua": lambda h, tr: h.replay_ua_stop(tr, 4, 2),
}


@pytest.mark.parametrize("name", list(REPLAYS))
def test_harness_replays_match_the_reference(harnesses, name):
    """Exit lines exact; Pass@1 and tokens at those lines exact; the area
    under the accuracy-vs-tokens curve to 1e-12."""
    ref, port = harnesses
    tr = _synthetic_trace()
    lines = REPLAYS[name](port, tr)
    np.testing.assert_array_equal(lines, REPLAYS[name](ref, tr))
    assert (lines < tr["n_tokens"].shape[0] - 1).any()
    acc, toks = port.pass1_at_line(tr, lines), port.tokens_at_line(tr, lines)
    np.testing.assert_array_equal(acc, ref.pass1_at_line(tr, lines))
    np.testing.assert_array_equal(toks, ref.tokens_at_line(tr, lines))
    for rng in (None, (0.0, 200.0)):
        assert abs(port.curve_auc(toks, acc, rng) - ref.curve_auc(toks, acc, rng)) <= 1e-12


def test_harness_builds_a_trace_from_the_engine(tiny, batch, harnesses):
    """``build_trace`` on the port's engine gives the reference's keys and
    shapes: (L, B) per point, (L, K, B) answers."""
    eng = _engine(tiny[2])
    tr = harnesses[1].build_trace(eng, batch, rollout_k=2, rollout_len=4,
                                  max_tokens=12, rng=torch.Generator().manual_seed(0))
    L = tr["n_tokens"].shape[0]
    assert L == 3 and tr["answers"].shape == (L, 2, 4)
    for key in ("due", "eat", "confidence"):
        assert tr[key].shape == (L, 4)
    np.testing.assert_array_equal(tr["n_tokens"][:, 0], [5, 9, 12])
