"""Mamba2 (SSD, state-space duality) block, arXiv:2405.21060 (port of
``repro/models/ssm.py``).

Prefill runs the chunked SSD scan (``kernels.ssd_scan``); decode carries a
recurrent state:
  ``ssm``  : (B, nh, N, hp) float32  h_t = a_t h_{t-1} + dt_t B_t x_t
  ``conv`` : {"x": (B, w-1, d_inner), "bc": (B, w-1, 2 G N)}  conv tails.

Both ``ssm_forward`` and ``ssm_step`` are pure: they return a new state and
never write the one they are given.  Committing a step is the caller's
choice of keeping it (``models/transformer.py forward_cached``), so a probe
or a rollout simply drops it, as in the reference.

Dtypes are the reference's: projections and the convolution run in the
storage dtype; dt, logd, the scan inputs u / B / C, the scan itself and the
state are float32, also in a bfloat16 model.  Invalid positions (``valid``
False) get x = 0 and dt = 0: decay exp(0) = 1 and zero input, so the state
passes through them unchanged.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.common import dense_init, normal_init, rmsnorm


class SSMDims(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    n_groups: int
    d_state: int
    conv_dim: int
    conv_width: int
    chunk: int


def ssm_dims(cfg: ModelConfig) -> SSMDims:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return SSMDims(d_inner, nh, s.head_dim, s.n_groups, s.d_state, conv_dim,
                   s.conv_width, s.chunk)


def ssm_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """The reference's layout and scales: separate w_z / w_x / w_b / w_c /
    w_dt projections; dt_bias, A_log and D in float32 whatever ``dtype``."""
    dm = ssm_dims(cfg)
    gn = dm.n_groups * dm.d_state
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((dm.n_heads,), generator=gen, device=device) * (hi - lo) + lo
    dt_bias = torch.log(torch.expm1(torch.exp(u)))          # inverse softplus
    d = cfg.d_model
    return {
        "w_z": dense_init(gen, d, dm.d_inner, dtype, device),
        "w_x": dense_init(gen, d, dm.d_inner, dtype, device),
        "w_b": dense_init(gen, d, gn, dtype, device),
        "w_c": dense_init(gen, d, gn, dtype, device),
        "w_dt": dense_init(gen, d, dm.n_heads, dtype, device),
        "conv_x_w": normal_init(gen, (dm.conv_width, dm.d_inner), 0.1, dtype, device),
        "conv_x_b": torch.zeros((dm.d_inner,), dtype=dtype, device=device),
        "conv_bc_w": normal_init(gen, (dm.conv_width, 2 * gn), 0.1, dtype, device),
        "conv_bc_b": torch.zeros((2 * gn,), dtype=dtype, device=device),
        "dt_bias": dt_bias.float(),
        "A_log": torch.log(torch.arange(1, dm.n_heads + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((dm.n_heads,), dtype=torch.float32, device=device),
        "norm_w": torch.ones((dm.d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, dm.d_inner, d, dtype, device),
    }


def _proj(p: dict, x: torch.Tensor):
    """x -> (z, x_conv_in, bc_conv_in, dt_raw)."""
    bc = torch.cat([x @ p["w_b"], x @ p["w_c"]], dim=-1)
    return x @ p["w_z"], x @ p["w_x"], bc, x @ p["w_dt"]


def _causal_conv(xs: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None):
    """Depthwise causal conv.  xs (B, S, C); w (W, C); tail (B, W-1, C) or
    None.  Returns (silu(y), new_tail)."""
    W = w.shape[0]
    Bsz, S, C = xs.shape
    if tail is None:
        tail = torch.zeros((Bsz, W - 1, C), dtype=xs.dtype, device=xs.device)
    full = torch.cat([tail, xs], dim=1)                      # (B, S+W-1, C)
    y = torch.zeros_like(xs)
    for i in range(W):
        y = y + full[:, i:i + S] * w[i]
    # a copy, not a view: the tail outlives ``full`` in the cache
    return F.silu(y + b), full[:, -(W - 1):].clone()


def _gate_out(p: dict, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig, dm: SSMDims) -> torch.Tensor:
    """y (B, m, nh, hp) float32 scan output -> the block output (B, m, d):
    the D skip, the silu(z) gate, the gated rmsnorm and out_proj."""
    Bsz, m = y.shape[:2]
    y = y + xh * p["D"][:, None]
    y = y.reshape(Bsz, m, dm.d_inner).to(z.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"]


def ssm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                valid: torch.Tensor | None = None, conv_tail: dict | None = None,
                h0: torch.Tensor | None = None, scan_impl: str = "auto"):
    """Full-sequence Mamba2 block (prefill).  x (B, S, d); valid (B, S)
    bool.  Returns (y (B, S, d), state {"ssm": h, "conv": tails})."""
    dm = ssm_dims(cfg)
    Bsz, S, _ = x.shape
    if valid is not None:
        x = x * valid[..., None].to(x.dtype)
    z, xi, bc_in, dt_raw = _proj(p, x)
    xc, tail_x = _causal_conv(xi, p["conv_x_w"], p["conv_x_b"],
                              None if conv_tail is None else conv_tail["x"])
    bc, tail_bc = _causal_conv(bc_in, p["conv_bc_w"], p["conv_bc_b"],
                               None if conv_tail is None else conv_tail["bc"])
    gn = dm.n_groups * dm.d_state
    b, c = bc[..., :gn], bc[..., gn:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])              # (B, S, nh)
    if valid is not None:
        dt = dt * valid[..., None].float()
    A = -torch.exp(p["A_log"])                                  # (nh,)
    logd = dt * A

    xh = xc.reshape(Bsz, S, dm.n_heads, dm.head_dim).float()
    u = xh * dt[..., None]
    bm = b.reshape(Bsz, S, dm.n_groups, dm.d_state).float().contiguous()
    cm = c.reshape(Bsz, S, dm.n_groups, dm.d_state).float().contiguous()
    y, h_final = ssd_scan(u, logd, bm, cm, chunk=dm.chunk, h0=h0, impl=scan_impl)
    out = _gate_out(p, y, xh, z, cfg, dm)
    return out, {"ssm": h_final, "conv": {"x": tail_x, "bc": tail_bc}}


def ssm_step(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict):
    """Recurrent decode of m tokens (m small, usually 1), one after the
    other, unmasked (as every caller in the reference steps).  Returns
    (y (B, m, d), new_state); ``state`` is left as it was."""
    dm = ssm_dims(cfg)
    Bsz, m, _ = x.shape
    z, xi, bc_in, dt_raw = _proj(p, x)
    xc, tail_x = _causal_conv(xi, p["conv_x_w"], p["conv_x_b"], state["conv"]["x"])
    bc, tail_bc = _causal_conv(bc_in, p["conv_bc_w"], p["conv_bc_b"],
                               state["conv"]["bc"])
    gn = dm.n_groups * dm.d_state
    b, c = bc[..., :gn], bc[..., gn:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    xh = xc.reshape(Bsz, m, dm.n_heads, dm.head_dim).float()
    rep = dm.n_heads // dm.n_groups
    bm = b.reshape(Bsz, m, dm.n_groups, dm.d_state).float().repeat_interleave(rep, 2)
    cm = c.reshape(Bsz, m, dm.n_groups, dm.d_state).float().repeat_interleave(rep, 2)
    h = state["ssm"]
    ys = []
    for t in range(m):
        a_t = torch.exp(dt[:, t] * A)                           # (B, nh)
        upd = (bm[:, t] * dt[:, t, :, None])[..., None] * xh[:, t, :, None, :]
        h = a_t[..., None, None] * h + upd                      # (B, nh, N, hp)
        ys.append(torch.einsum("bhn,bhnp->bhp", cm[:, t], h))
    y = torch.stack(ys, dim=1)                                  # (B, m, nh, hp)
    out = _gate_out(p, y, xh, z, cfg, dm)
    return out, {"ssm": h, "conv": {"x": tail_x, "bc": tail_bc}}


def ssm_state_init(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """A zero recurrent state: the scan state in float32, the conv tails in
    the storage dtype."""
    dm = ssm_dims(cfg)
    gn = dm.n_groups * dm.d_state
    return {
        "ssm": torch.zeros((batch, dm.n_heads, dm.d_state, dm.head_dim),
                           dtype=torch.float32, device=device),
        "conv": {
            "x": torch.zeros((batch, dm.conv_width - 1, dm.d_inner), dtype=dtype,
                             device=device),
            "bc": torch.zeros((batch, dm.conv_width - 1, 2 * gn), dtype=dtype,
                              device=device),
        },
    }
