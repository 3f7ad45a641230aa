"""Mamba2 (SSD) layer for serving: prefill, cached multi-token decode and
speculative rollback (a port of the serving half of ``repro.models.ssm``;
the full-sequence training pass comes with ROADMAP M10).

An SSM cannot roll back by rewinding a length pointer: the recurrent state
at the accepted position must be recovered.  ``mamba_decode`` therefore
keeps the state and the conv window after EVERY verified token
(``states_all``, ``conv_all``) and ``Model.commit_cache`` selects the one at
the accepted index.  Unlike the JAX package, the port writes them into
preallocated cache tensors in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm

# per-slot cache entries of an SSM layer, and the per-step ones decode keeps
CACHE_KEYS = ("conv", "state")
STEP_KEYS = ("states_all", "conv_all")


def _dims(cfg):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    return s, d_in, s.n_heads(cfg.d_model), d_in + 2 * s.n_groups * s.d_state


def init_mamba(gen, cfg, dtype, device):
    """Split input projections (z / xBC / dt), as the reference keeps them.
    ``A_log``, ``D`` and ``dt_bias`` stay float32 whatever the model dtype."""
    s, d_in, nh, conv_ch = _dims(cfg)
    d = cfg.d_model
    conv_w = torch.empty(s.d_conv, conv_ch, device=device).normal_(0.0, 1.0, generator=gen)
    return {
        "in_z": dense_init(gen, d, d_in, dtype, device),
        "in_xbc": dense_init(gen, d, conv_ch, dtype, device),
        "in_dt": dense_init(gen, d, nh, dtype, device),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)),
        "D": torch.ones(nh, device=device),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 0.1, nh, device=device))),
        "norm": torch.ones(d_in, dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_in, d, dtype, device),
    }


def _project_in(p, h):
    return h @ p["in_z"], h @ p["in_xbc"], h @ p["in_dt"]


def _conv(window, w, b, T):
    """Depthwise causal conv: output t sees window rows [t, t + d_conv)."""
    return F.silu(sum(window[:, i:i + T] * w[i] for i in range(w.shape[0])) + b)


def _ssd_inputs(cfg, xBC, dt_raw, A_log, dt_bias):
    """Split the conv output into x (…, H, P), B and C (…, G, N) views, and
    dt = softplus(dt_raw + dt_bias), A = -exp(A_log) in float32."""
    s, d_in, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    shp = xBC.shape[:-1]
    x = xBC[..., :d_in].reshape(*shp, nh, s.head_dim)
    Bm = xBC[..., d_in:d_in + gn].reshape(*shp, s.n_groups, s.d_state)
    C = xBC[..., d_in + gn:].reshape(*shp, s.n_groups, s.d_state)
    return x, F.softplus(dt_raw.float() + dt_bias), -torch.exp(A_log), Bm, C


def _out(p, cfg, y, x, z):
    """Skip term, gate, norm and the output projection."""
    y = y + x * p["D"].to(y.dtype)[:, None]
    y = rms_norm(y.reshape(*y.shape[:2], -1) * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba_prefill(p, cfg, h):
    """Prefill of unpadded rows (B, S, d_model).  Returns (out, (conv, state)):
    the last d_conv - 1 raw conv inputs (zeros before the prompt) and the
    final SSD state, fp32.  Every call runs the SSD-scan kernel once."""
    s = cfg.ssm
    S = h.shape[1]
    z, xBC, dt_raw = _project_in(p, h)
    padded = F.pad(xBC, (0, 0, s.d_conv - 1, 0))
    x, dt, A, Bm, C = _ssd_inputs(cfg, _conv(padded, p["conv_w"], p["conv_b"], S), dt_raw,
                                  p["A_log"], p["dt_bias"])
    y, state = ops.ssd_scan(x, dt, A, Bm, C, chunk=s.chunk_size)
    return _out(p, cfg, y, x, z), (padded[:, -(s.d_conv - 1):], state)


def mamba_decode(p, cfg, h, cache):
    """Decode T tokens (B, T, d_model) against per-layer cache views:
    ``conv`` (B, d_conv-1, C_ch), ``state`` (B, H, P, N) fp32, and
    ``states_all`` / ``conv_all`` with at least T positions.  Writes the state
    and conv window after each token into ``[:, :T]`` of the latter, and
    advances ``conv`` and ``state`` to the last token, all in place."""
    s = cfg.ssm
    T = h.shape[1]
    z, xBC, dt_raw = _project_in(p, h)
    full = torch.cat([cache["conv"], xBC], 1)                 # (B, d_conv-1+T, C_ch)
    x, dt, A, Bm, C = _ssd_inputs(cfg, _conv(full, p["conv_w"], p["conv_b"], T), dt_raw,
                                  p["A_log"], p["dt_bias"])
    st, ys = cache["state"], []
    for t in range(T):  # the per-token recurrence, keeping every state
        st, yt = ops.ssd_decode_step(st, x[:, t], dt[:, t], A, Bm[:, t], C[:, t],
                                     out=cache["states_all"][:, t])
        ys.append(yt)
    # the window after token t is full[t + 1 : t + d_conv]
    cache["conv_all"][:, :T] = full.unfold(1, s.d_conv - 1, 1)[:, 1:].transpose(2, 3)
    cache["state"].copy_(st)
    cache["conv"].copy_(cache["conv_all"][:, T - 1])
    return _out(p, cfg, torch.stack(ys, 1), x, z)


def init_mamba_cache(cfg, n_layers, batch, dtype, device, steps=0):
    """Zeroed per-slot SSM cache stacked over ``n_layers`` (plus the per-step
    ``states_all`` / ``conv_all`` for ``steps`` decode positions when > 0)."""
    s, _, nh, conv_ch = _dims(cfg)
    conv = (n_layers, batch, s.d_conv - 1, conv_ch)
    state = (n_layers, batch, nh, s.head_dim, s.d_state)
    cache = {"conv": torch.zeros(conv, dtype=dtype, device=device),
             "state": torch.zeros(state, device=device)}
    if steps:
        cache["states_all"] = torch.zeros((*state[:2], steps, *state[2:]), device=device)
        cache["conv_all"] = torch.zeros((*conv[:2], steps, *conv[2:]), dtype=dtype,
                                        device=device)
    return cache
