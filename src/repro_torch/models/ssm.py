"""Mamba2 (SSD) layer: the full-sequence training pass, prefill, cached
multi-token decode and speculative rollback (a port of ``repro.models.ssm``).

An SSM cannot roll back by rewinding a length pointer: the recurrent state
at the accepted position must be recovered.  ``mamba_decode`` therefore
keeps the state and the conv window after EVERY verified token
(``states_all``, ``conv_all``) and ``Model.commit_cache`` selects the one at
the accepted index.  Unlike the JAX package, the port writes them into
preallocated cache tensors in place.

Under a mesh the layer takes this rank's shards (``shard_params`` under
``INFERENCE_RULES``): ``in_z``, ``norm`` and ``out_proj`` on "inner",
``in_xbc`` and the conv on "conv" (a contiguous slice of the x | B | C
channels), ``in_dt``, ``A_log``, ``D``, ``dt_bias`` and the state on "heads".
The depthwise conv runs on the rank's channels (its cache holds their raw
window), one all-gather over "model" joins them, and the rank takes its
heads' x and the shared B and C groups; the gated RMSNorm sums its squares
over "model" and ``out_proj`` is row parallel, summed over "model".  Under
autograd (training) the layer's whole inputs enter its rank-specific parts
through ``model_copy``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import model_copy, model_gather, model_split, model_sum
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


def _project_in(p, cfg, h):
    """z, xBC and dt_raw; under autograd the whole h enters the sharded
    products through ``model_copy``."""
    _, d_in, nh, conv_ch = _dims(cfg)
    hc = model_copy(h)  # where the model axis splits them
    return tuple((hc if model_split(p[k].shape[1], n)[2] else h) @ p[k]
                 for k, n in (("in_z", d_in), ("in_xbc", conv_ch), ("in_dt", nh)))


def _conv(window, w, b, T):
    """Depthwise causal conv: output t sees window rows [t, t + d_conv)."""
    return F.silu(sum(window[:, i:i + T] * w[i] for i in range(w.shape[0])) + b)


def _ssd_inputs(cfg, xBC, dt_raw, A_log, dt_bias):
    """Split the conv output into x (…, H, P), B and C (…, G, N) views, and
    dt = softplus(dt_raw + dt_bias), A = -exp(A_log) in float32.  Under
    tensor parallelism xBC holds this rank's channels: gathered over
    "model", x keeps the rank's heads (as many as ``A_log`` holds)."""
    s, d_in, nh, conv_ch = _dims(cfg)
    gn = s.n_groups * s.d_state
    if model_split(xBC.shape[-1], conv_ch)[2]:
        xBC = model_gather(xBC, -1)
    shp, h = xBC.shape[:-1], A_log.shape[0]
    _, j, sharded = model_split(h, nh)
    xBC = model_copy(xBC, sharded)  # the rank's heads' x, and B and C for them
    lo = j * h * s.head_dim if sharded else 0
    x = xBC[..., lo:lo + h * s.head_dim].reshape(*shp, h, s.head_dim)
    Bm = xBC[..., d_in:d_in + gn].reshape(*shp, s.n_groups, s.d_state)
    C = xBC[..., d_in + gn:].reshape(*shp, s.n_groups, s.d_state)
    return x, F.softplus(dt_raw.float() + dt_bias), -torch.exp(A_log), Bm, C


def _out(p, cfg, y, x, z):
    """Skip term, gate, norm and the output projection; on a shard of the
    inner channels the norm's sum of squares and the product are summed
    over "model"."""
    y = (y + x * p["D"].to(y.dtype)[:, None]).reshape(*y.shape[:2], -1) * F.silu(z)
    d_in = cfg.ssm.d_inner(cfg.d_model)
    if not model_split(y.shape[-1], d_in)[2]:
        return rms_norm(y, p["norm"], cfg.norm_eps) @ p["out_proj"]
    yf = y.float()
    var = model_copy(model_sum(yf.square().sum(-1, keepdim=True), True)) / d_in
    y = (yf * torch.rsqrt(var + cfg.norm_eps) * p["norm"].float()).to(y.dtype)
    return model_sum(y @ p["out_proj"], True)


def _full(p, cfg, h):
    """The layer over whole rows (B, S, d_model): (out, the padded raw conv
    input, the final SSD state fp32).  Every call runs the SSD scan once."""
    s = cfg.ssm
    z, xBC, dt_raw = _project_in(p, cfg, h)
    padded = F.pad(xBC, (0, 0, s.d_conv - 1, 0))
    x, dt, A, Bm, C = _ssd_inputs(cfg, _conv(padded, p["conv_w"], p["conv_b"], h.shape[1]),
                                  dt_raw, p["A_log"], p["dt_bias"])
    y, state = ops.ssd_scan(x, dt, A, Bm, C, chunk=s.chunk_size)
    return _out(p, cfg, y, x, z), padded, state


def mamba_full(p, cfg, h):
    """Full-sequence forward (training): (B, S, d_model) -> (B, S, d_model).
    On the card under autograd the scan runs K4's forward and backward."""
    return _full(p, cfg, h)[0]


def mamba_prefill(p, cfg, h):
    """Prefill of unpadded rows (B, S, d_model).  Returns (out, (conv, state)):
    the last d_conv - 1 raw conv inputs (zeros before the prompt) and the
    final SSD state, fp32."""
    out, padded, state = _full(p, cfg, h)
    return out, (padded[:, -(cfg.ssm.d_conv - 1):], state)


def mamba_decode(p, cfg, h, cache):
    """Decode T tokens (B, T, d_model) against per-layer cache views:
    ``conv`` (B, d_conv-1, C_ch), ``state`` (B, H, P, N) fp32, and
    ``states_all`` / ``conv_all`` with at least T positions.  Writes the state
    and conv window after each token into ``[:, :T]`` of the latter, and
    advances ``conv`` and ``state`` to the last token, all in place."""
    s = cfg.ssm
    T = h.shape[1]
    z, xBC, dt_raw = _project_in(p, cfg, h)
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


def mamba_cache_layout(cfg, n_layers, batch, dtype, steps=0):
    """{key: (shape, dtype, fill)} of the per-slot SSM cache stacked over
    ``n_layers``, plus the per-step ``states_all`` / ``conv_all`` for
    ``steps`` decode positions when > 0 (``Model._make`` allocates it)."""
    s, _, nh, conv_ch = _dims(cfg)
    conv = (n_layers, batch, s.d_conv - 1, conv_ch)
    state = (n_layers, batch, nh, s.head_dim, s.d_state)
    out = {"conv": (conv, dtype, 0), "state": (state, torch.float32, 0)}
    if steps:
        out["states_all"] = ((*state[:2], steps, *state[2:]), torch.float32, 0)
        out["conv_all"] = ((*conv[:2], steps, *conv[2:]), dtype, 0)
    return out

