"""The fused decode-and-probe step (``Model.decode_and_probe``,
``make_eat_step(fused_probe=True)``, ``build_serve_step_program``) against
the JAX reference on the CPU (float32, 1e-5; parameters carried by
``params.from_jax``; the JAX side on ``attn_impl="xla"``, as its own tests
run it).

* ``decode_and_probe`` after a left-padded prefill, against the
  reference's and against the port's own separate step (``decode_step``
  then ``probe_entropy``) from the same cache, then the two following
  ``decode_step``s from each cache (the stale probe K/V are masked), as
  the reference's ``tests/test_parity.py`` does: for ``tiny``,
  ``tiny-moe``, ``tiny-ssm``, ``zamba2-2.7b``, ``deepseek-v2-236b`` (MLA),
  ``seamless-m4t-large-v2`` (with frames) and ``qwen2-vl-7b`` (M-RoPE
  positions (B, 1 + m, 3)), reduced; on a ring cache, a paged cache
  (shuffled pages of 4; held to the reference's ring numbers, which its
  paged cache gives bit for bit) and a sliding-window ring that wraps.  The port's model reads a cache as the
  serving engine's does (``paged_attn_impl="auto"``: the paged kernel's
  plain version at m 3 on the CPU).  A recurrent stack's fused step is
  the separate step, bitwise (the reference's fallback).
* The fused step on the paged cache equals the ring's bitwise.
* The fused step's probe slots past a row's mapped pages (K/V to the trash
  page), against the reference's paged cache with the same read (gathered,
  page-native, MLA), then two decode steps once the block is mapped.
* ``make_eat_step(fused_probe=True)`` over 12 greedy steps against the
  reference's: tokens, exit steps and exit reasons exactly, the EAT and
  EMA-variance traces within 1e-5.
* One ``build_serve_step_program`` step, fused and not, against the
  reference's single-device program.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.core.eat import ProbeSpec as JProbeSpec
from repro.core.monitor import ReasoningMonitor as JMonitor
from repro.core.stopping import EATStopper as JStopper
from repro.models import Model as JModel
from repro.serving import cache as jex_cache
from repro.serving.cache import alloc_cache as jalloc
from repro.serving import executor as jex
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch.configs.base import get_config
from repro_torch.core.eat import ProbeSpec
from repro_torch.core.monitor import ReasoningMonitor
from repro_torch.core.stopping import EATStopper
from repro_torch.models.common import positions_for
from repro_torch.models.model import Model
from repro_torch.params import from_jax
from repro_torch.serving import executor as ex
from repro_torch.serving.cache import alloc_cache, alloc_paged_cache, blocks_arrays
from repro_torch.serving.sampler import SamplerConfig

from _torch_threads import _one_thread  # noqa: F401

FAMILIES = ["tiny", "tiny-moe", "tiny-ssm", "zamba2-2.7b:reduced",
            "deepseek-v2-236b:reduced", "seamless-m4t-large-v2:reduced",
            "qwen2-vl-7b:reduced"]
B, S, PAD, PS = 2, 8, 2, 4
PROBE = (1, 6)
#: the sliding-window case: window 6 over a ring of 10 slots, which the
#: prompt of 8 and the steps after it wrap (capacity >= window + 1 + m, so
#: the probe's writes land on slots the window already masks)
WINDOW, WRAP_C = 6, 10


def _cfgs(name, kind):
    base = name.split(":")[0]
    jcfg, cfg = jget(base), get_config(base)
    if name.endswith(":reduced"):
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    if kind == "window":
        jcfg, cfg = (dataclasses.replace(c, sliding_window=WINDOW) for c in (jcfg, cfg))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _pair(name, kind="ring"):
    """(reference model, its parameters, port config, port parameters);
    the windowed configs share the ring's parameters (a window changes no
    weight)."""
    jcfg, cfg = _cfgs(name, kind)
    if kind == "window":
        _, jparams, _, params = _pair(name)
    else:
        jparams = jax.jit(JModel(jcfg, attn_impl="xla").init)(jax.random.PRNGKey(11))
        params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return JModel(jcfg, attn_impl="xla"), jparams, cfg, params


@functools.lru_cache(maxsize=None)
def _jit(jm, method: str):
    """A reference model's entry point, jitted once per model: its scans
    then compile once for every call of the same shapes."""
    fn = getattr(jm, method)
    if method == "decode_and_probe":
        fn = functools.partial(fn, entropy_impl="xla")
    return jax.jit(fn)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _close(a, b, what):
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5, err_msg=what)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


def _port_cache(cfg, kind):
    """A ring of 24 slots (or the wrapping ring of 10), or a paged cache of
    24 logical slots in pages of 4, every row's blocks on pages of its own
    in a shuffled order, with the compacted page list the page-native read
    takes."""
    if kind != "paged":
        return alloc_cache(cfg, B, WRAP_C if kind == "window" else 24, device="cpu")
    C, NB = 24, 24 // PS
    pages = (np.random.default_rng(1).permutation(B * NB) + 1).reshape(B, NB)
    pages = pages.astype(np.int32)
    cache = alloc_paged_cache(cfg, B, C, PS, 1 + B * NB, device="cpu")
    cache["page_table"].copy_(torch.from_numpy(pages))
    logical = np.broadcast_to(np.arange(NB, dtype=np.int32), (B, NB)).copy()
    cache["blocks"] = blocks_arrays(pages, logical, np.full(B, NB, np.int32),
                                    device="cpu")
    return cache


def _prompt(cfg):
    """Left-padded prompts (row 1 by PAD), their positions, and an
    encoder-decoder's frames."""
    rng = np.random.default_rng(3)
    toks = rng.integers(4, cfg.vocab, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, :PAD], pos[1, PAD:], toks[1, :PAD] = -1, np.arange(S - PAD), 0
    frames = None
    if cfg.arch_type == "encdec":
        frames = (0.5 * rng.standard_normal((B, cfg.encoder_len, cfg.d_model))
                  ).astype(np.float32)
    return toks, pos, frames


def _p3(cfg, p):
    """The positions a model takes: 3 M-RoPE streams, all ``p``."""
    if cfg.mrope_sections:
        return np.broadcast_to(p[..., None], p.shape + (3,)).copy()
    return p


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


TOK, TOK2 = np.full((B, 1), 3, np.int32), np.full((B, 1), 7, np.int32)
P1 = np.array([[S], [S - PAD]], np.int32)
PROBE_TOKS = np.array([PROBE] * B, np.int32)
POS_ALL = P1 + np.arange(1 + len(PROBE), dtype=np.int32)[None]


def _prefilled(name, kind):
    """The port's model (reading a cache as the serving engine does) and
    its cache of kind ``kind`` after the prompt's prefill."""
    _, _, cfg, params = _pair(name, "window" if kind == "window" else "ring")
    tm = Model(cfg, params, paged_attn_impl="auto", paged_attn_page=PS)
    toks, pos, frames = _prompt(cfg)
    cache = _port_cache(cfg, kind)
    tm.prefill(_t(toks, torch.long), _t(_p3(cfg, pos)), _t(pos), cache,
               **({} if frames is None else {"frames": torch.from_numpy(frames)}))
    return cfg, tm, cache


def _jax_prefilled(name, kind):
    """The reference's model and its ring cache after the same prefill."""
    jm, jparams, cfg, _ = _pair(name, kind)
    toks, pos, frames = _prompt(cfg)
    jcache = jalloc(jm.cfg, B, WRAP_C if kind == "window" else 24)
    _, jcache = _jit(jm, "prefill")(
        jparams, jnp.asarray(toks), jnp.asarray(_p3(cfg, pos)), jnp.asarray(pos), jcache,
        **({} if frames is None else {"frames": jnp.asarray(frames)}))
    return jm, jparams, cfg, jcache


@functools.lru_cache(maxsize=None)
def _reference(name, kind):
    """The reference's fused step after the same prefill, on its ring (or
    its wrapping windowed ring), and its next two decode steps: (logits,
    EAT, cur, [the two steps' logits]) as numpy.  A paged cache holds the
    same logical slots as the ring (the reference's paged == ring rule),
    so the port's paged cache is held to the ring's numbers."""
    jm, jparams, cfg, jcache = _jax_prefilled(name, kind)
    jl, je, jcache = _jit(jm, "decode_and_probe")(
        jparams, jnp.asarray(TOK), jnp.asarray(_p3(cfg, POS_ALL)), jnp.asarray(POS_ALL),
        jcache, jnp.asarray(PROBE_TOKS))
    cur, steps = int(jcache["cur"]), []
    for k in (1, 2):
        pk = P1 + k
        sl, jcache = _jit(jm, "decode_step")(jparams, jnp.asarray(TOK2),
                                             jnp.asarray(_p3(cfg, pk)), jnp.asarray(pk),
                                             jcache)
        steps.append(np.asarray(sl))
    return np.asarray(jl), np.asarray(je), cur, steps


def _cases():
    for name in FAMILIES:
        for kind in ("ring", "paged", "window"):
            # Mamba2 has neither pages nor a window (the reference's paged
            # cache refuses it)
            if name == "tiny-ssm" and kind != "ring":
                continue
            yield name, kind


@pytest.mark.parametrize("name,kind", list(_cases()))
def test_decode_and_probe_matches_jax_and_the_separate_step(name, kind):
    cfg, tm, fused = _prefilled(name, kind)
    jl, je, jcur, jsteps = _reference(name, "window" if kind == "window" else "ring")
    sep = _clone(fused)
    tl, te = tm.decode_and_probe(_t(TOK, torch.long), _t(_p3(cfg, POS_ALL)),
                                 _t(POS_ALL), fused, _t(PROBE_TOKS, torch.long))
    assert tuple(tl.shape) == (B, 1, cfg.padded_vocab) and tuple(te.shape) == (B,)
    _close(tl, jl, f"{name} {kind} fused logits vs the reference")
    _close(te, je, f"{name} {kind} fused EAT vs the reference")
    assert int(fused["cur"]) == jcur == S + 1
    # the port's separate step from the same cache state
    sl = tm.decode_step(_t(TOK, torch.long), _t(_p3(cfg, P1)), _t(P1), sep)
    pp = POS_ALL[:, 1:]
    se = tm.probe_entropy(_t(PROBE_TOKS, torch.long), _t(_p3(cfg, pp)), _t(pp), sep)
    if cfg.arch_type in ("ssm", "hybrid"):
        # the reference's fallback: the separate step itself
        assert torch.equal(tl, sl) and torch.equal(te, se)
    _close(tl, sl, f"{name} {kind} fused vs separate logits")
    _close(te, se, f"{name} {kind} fused vs separate EAT")
    assert int(sep["cur"]) == int(fused["cur"])
    # the next two decode steps agree (the stale probe K/V stay masked)
    for k, jstep in zip((1, 2), jsteps):
        pk = P1 + k
        fl = tm.decode_step(_t(TOK2, torch.long), _t(_p3(cfg, pk)), _t(pk), fused)
        sl = tm.decode_step(_t(TOK2, torch.long), _t(_p3(cfg, pk)), _t(pk), sep)
        _close(fl, jstep, f"{name} {kind} decode step {k} after the fused step vs the reference")
        _close(fl, sl, f"{name} {kind} decode step {k}: fused vs separate cache")


@pytest.mark.parametrize("name", ["tiny", "seamless-m4t-large-v2:reduced",
                                  "qwen2-vl-7b:reduced"])
def test_fused_step_paged_equals_ring_bitwise(name):
    """The port's paged == ring rule for the fused step: the page-native
    read (the paged kernel's plain version at m 3) over the pools and the
    same block algorithm over the ring give the same bits, and so do the
    decode steps after it."""
    outs = {}
    for kind in ("ring", "paged"):
        cfg, tm, cache = _prefilled(name, kind)
        tok = torch.full((B, 1), 3, dtype=torch.long)
        p1 = torch.tensor([[S], [S - PAD]], dtype=torch.int32)
        pos_all = p1 + torch.arange(1 + len(PROBE), dtype=torch.int32)[None]
        probe = torch.tensor([PROBE] * B, dtype=torch.long)
        pa = positions_for(cfg, pos_all)
        res = list(tm.decode_and_probe(tok, pa, pos_all, cache, probe))
        res.append(tm.decode_step(tok, positions_for(cfg, p1 + 1), p1 + 1, cache))
        outs[kind] = res
    for a, b in zip(outs["ring"], outs["paged"]):
        assert torch.equal(a, b)


# ------------------------------------------- probe writes past the mapped pages

#: row 0 maps logical blocks 0..2 (slots 0..11) and row 1 all six: after
#: the prompt and three decode steps (cur 11) the fused step's token lands
#: on row 0's last mapped slot and its two probe slots (12, 13) fall in the
#: unmapped block 3; block 3 is mapped to a fresh page before the two
#: decode steps after it, as an allocator maps a row's next block
TRASH_MAPPED = (3, 24 // PS)


def _trash_layout():
    """(pages (B, NB) with trash past each row's mapped blocks, the fresh
    page for row 0's block 3, the number of physical pages)."""
    NB = 24 // PS
    n = sum(TRASH_MAPPED)
    perm = (np.random.default_rng(5).permutation(n + 1) + 1).astype(np.int32)
    pages = np.zeros((B, NB), np.int32)
    pages[0, :TRASH_MAPPED[0]] = perm[:TRASH_MAPPED[0]]
    pages[1, :TRASH_MAPPED[1]] = perm[TRASH_MAPPED[0]:n]
    return pages, int(perm[n]), n + 2


def _map_blocks(pages):
    counts = (pages != 0).sum(1).astype(np.int32)
    logical = np.where(pages != 0, np.arange(pages.shape[1], dtype=np.int32)[None], 0)
    return pages, logical.astype(np.int32), counts


@functools.lru_cache(maxsize=None)
def _jax_paged_model(name, impl):
    jm, jparams, _, _ = _pair(name)
    return JModel(jm.cfg, attn_impl="xla", paged_attn_impl=impl, paged_attn_page=PS), jparams


@pytest.mark.parametrize("name,impl", [("tiny", "gather"), ("tiny", "native"),
                                       ("deepseek-v2-236b:reduced", "native")])
def test_fused_probe_writes_past_mapped_pages_match_jax(name, impl):
    """The fused step's probe slots past a row's mapped pages: the page-table
    write sends their K/V to the trash page (their positions to the row's
    ``pos``).  The gathered read then reads them back from the trash page;
    the page-native read (MLA gathers at every width) visits the row's
    mapped pages only, so the probe rows do not see the probe's own K/V
    there.  Either way the port follows the reference's paged cache with
    the same read: the fused step's logits and EAT, and the two decode
    steps after row 0's block 3 is mapped, within 1e-5."""
    jm, jparams = _jax_paged_model(name, "xla" if impl == "native" else "gather")
    _, _, cfg, params = _pair(name)
    tm = Model(cfg, params, paged_attn_impl="auto" if impl == "native" else "gather",
               paged_attn_page=PS)
    pages, fresh, P = _trash_layout()
    jcache = jex_cache.alloc_paged_cache(jm.cfg, B, 24, PS, P, block_bucket=24 // PS)
    jcache["page_table"] = jnp.asarray(pages)
    jcache["blocks"] = jex_cache.blocks_arrays(*_map_blocks(pages))
    cache = alloc_paged_cache(cfg, B, 24, PS, P, device="cpu")
    cache["page_table"].copy_(torch.from_numpy(pages))
    cache["blocks"] = blocks_arrays(*_map_blocks(pages), device="cpu")
    toks, pos, frames = _prompt(cfg)
    assert frames is None
    _, jcache = _jit(jm, "prefill")(jparams, jnp.asarray(toks), jnp.asarray(pos),
                                    jnp.asarray(pos), jcache)
    tm.prefill(_t(toks, torch.long), _t(pos), _t(pos), cache)

    def both_decode(k):
        nonlocal jcache
        pk = P1 + k
        jl, jcache = _jit(jm, "decode_step")(jparams, jnp.asarray(TOK2), jnp.asarray(pk),
                                             jnp.asarray(pk), jcache)
        tl = tm.decode_step(_t(TOK2, torch.long), _t(pk), _t(pk), cache)
        _close(tl, jl, f"{name} {impl} decode step at P1 + {k}")

    for k in range(3):
        both_decode(k)
    assert int(cache["cur"]) == int(jcache["cur"]) == 11
    pos_all = P1 + 3 + np.arange(1 + len(PROBE), dtype=np.int32)[None]
    jl, je, jcache = _jit(jm, "decode_and_probe")(
        jparams, jnp.asarray(TOK), jnp.asarray(pos_all), jnp.asarray(pos_all), jcache,
        jnp.asarray(PROBE_TOKS))
    tl, te = tm.decode_and_probe(_t(TOK, torch.long), _t(pos_all), _t(pos_all), cache,
                                 _t(PROBE_TOKS, torch.long))
    _close(tl, jl, f"{name} {impl} fused logits past the mapped pages")
    _close(te, je, f"{name} {impl} fused EAT past the mapped pages")
    assert int(cache["cur"]) == int(jcache["cur"]) == 12
    # the probe's positions are in row 0's pos, its K/V in the trash page
    np.testing.assert_array_equal(cache["pos"][0, 12:14].numpy(), pos_all[0, 1:])
    pages[0, 3] = fresh
    jcache["page_table"] = jnp.asarray(pages)
    jcache["blocks"] = jex_cache.blocks_arrays(*_map_blocks(pages))
    cache["page_table"].copy_(torch.from_numpy(pages))
    cache["blocks"] = blocks_arrays(*_map_blocks(pages), device="cpu")
    for k in (4, 5):
        both_decode(k)


# ------------------------------------------------------------ the EAT step


def _monitors():
    kw = dict(schedule="every_n", every_n=2, min_evals=2)
    return (JMonitor(stopper=JStopper(alpha=0.2, delta=1e9), probe=JProbeSpec(PROBE), **kw),
            ReasoningMonitor(stopper=EATStopper(alpha=0.2, delta=1e9),
                             probe=ProbeSpec(PROBE), **kw))


@pytest.mark.parametrize("name", ["tiny", "tiny-ssm", "deepseek-v2-236b:reduced",
                                  "qwen2-vl-7b:reduced"])
def test_fused_eat_step_matches_jax_over_12_greedy_steps(name):
    """12 greedy fused steps from a prefill, a probe due every 2 tokens and
    an exit at the 2nd evaluation (delta 1e9); row 1 is taken inactive
    after step 1 and back at step 5, so the rows exit at different steps.
    Tokens, exit steps and reasons exactly; EAT and variance within 1e-5."""
    jm, jparams, _, jcache = _jax_prefilled(name, "ring")
    cfg, tm, tcache = _prefilled(name, "ring")
    jmon_cfg, mon_cfg = _monitors()
    jstep = jax.jit(jex.make_eat_step(jm, jmon_cfg, JSampler(greedy=True),
                                      probe_cond=False, fused_probe=True))
    step = ex.make_eat_step(tm, mon_cfg, SamplerConfig(greedy=True), probe_cond=False,
                            fused_probe=True)
    jmon, mon = jmon_cfg.init(B), mon_cfg.init(B, "cpu")
    tok = np.full((B, 1), 3, np.int32)
    pos = np.array([[S], [S - PAD]], np.int32)
    jtok, ttok = jnp.asarray(tok), _t(tok, torch.long)
    rng = jax.random.PRNGKey(0)
    exits = {"jax": [None] * B, "port": [None] * B}
    for i in range(12):
        active = np.array([True, not (1 <= i < 5)])
        jnxt, jcache, jmon, jstop, rng = jstep(jparams, jcache, jtok, jnp.asarray(pos),
                                               jmon, jnp.asarray(active), rng)
        nxt, mon, stop = step(tcache, ttok, _t(pos), mon, torch.from_numpy(active), None)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt), err_msg=f"step {i}")
        for who, st in (("jax", np.asarray(jstop)), ("port", stop.numpy())):
            for b in range(B):
                if st[b] and exits[who][b] is None:
                    exits[who][b] = (i, "eat")
        for a, b_ in ((mon.stop_state.last, jmon.stop_state.last),
                      (mon.stop_state.ema.var, jmon.stop_state.ema.var)):
            _close(a, b_, f"{name} step {i}")
        np.testing.assert_array_equal(mon.n_evals.numpy(), np.asarray(jmon.n_evals))
        jtok, ttok = jnxt[:, None], nxt[:, None]
        pos = pos + 1
    assert exits["port"] == exits["jax"]
    assert all(e is not None for e in exits["port"]), exits
    assert exits["port"][0] != exits["port"][1]


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused"])
def test_serve_step_program_matches_jax(fused):
    """One step of the every-token serve program (no mesh) on ``tiny``."""
    jm, jparams, _, jcache = _jax_prefilled("tiny", "ring")
    cfg, tm, tcache = _prefilled("tiny", "ring")
    jscfg = jex.ServeStepConfig(sampler=JSampler(greedy=True), fused_probe=fused)
    scfg = ex.ServeStepConfig(sampler=SamplerConfig(greedy=True), fused_probe=fused)
    jfn, _ = jex.build_serve_step_program(jm, jscfg, jcache, jparams)
    jmon = jex.serve_monitor(jscfg).init(B)
    step, mon = ex.build_serve_step_program(tm, scfg, tcache)
    assert mon.n_evals.shape == (B,) and not bool(mon.stop_flag.any())
    tok = np.full((B, 1), 3, np.int32)
    pos = np.array([[S], [S - PAD]], np.int32)
    jnxt, jcache, jmon, jstop, _ = jfn(jparams, jcache, jnp.asarray(tok),
                                       jnp.asarray(pos), jmon, jax.random.PRNGKey(0))
    nxt, mon, stop = step(tcache, _t(tok, torch.long), _t(pos), mon, None)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_array_equal(stop.numpy(), np.asarray(jstop))
    np.testing.assert_array_equal(mon.n_evals.numpy(), np.asarray(jmon.n_evals))
    assert mon.n_evals.tolist() == [1, 1]
    _close(mon.stop_state.last, jmon.stop_state.last, "EAT")
    assert int(tcache["cur"]) == int(jcache["cur"]) == S + 1


def test_fused_eat_step_takes_no_live_mask():
    """A masked chunk builds the step non-fused: the fused step refuses
    ``live`` rather than commit a masked forward it was never held to."""
    cfg, tm, tcache = _prefilled("tiny", "ring")
    _, mon_cfg = _monitors()
    step = ex.make_eat_step(tm, mon_cfg, SamplerConfig(greedy=True), probe_cond=False,
                            fused_probe=True)
    with pytest.raises(ValueError, match="live"):
        step(tcache, _t(TOK, torch.long), _t(P1), mon_cfg.init(B, "cpu"),
             torch.ones(B, dtype=torch.bool), None, torch.tensor(False))


def test_serve_monitor_is_every_token():
    mon = ex.serve_monitor(ex.ServeStepConfig())
    assert (mon.schedule, mon.every_n, mon.min_evals) == ("every_n", 1, 0)
    assert mon.probe.tokens == PROBE
