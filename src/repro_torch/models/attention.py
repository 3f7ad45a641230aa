"""GQA attention with RoPE, qk-norm and a dense ring-buffer or paged KV
cache (a port of ``repro.models.attention``; QKV bias and the reference's
tensor-parallel head padding come with ROADMAP M9).

Dense cache per attention layer: ``k``/``v`` (B, cap, K, D) and ``kv_pos``
(B, cap) int32, the absolute position written into each slot (-1 = empty).
Slots are addressed ``pos % cap``.  Speculative rollback leaves stale slots
behind; the positional mask makes them unreachable until overwritten.

Paged cache per attention layer: a global pool ``k``/``v`` (n_pages + 1, ps,
K, D) shared by every row through (B, P) block tables.  The last page is a
spare that absorbs the writes JAX drops (``mode="drop"``), so the scatter
needs no host sync; attention sees only the first n_pages.
"""
from __future__ import annotations


import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm, rope

SPEC_MARGIN = 32  # ring-buffer slack for uncommitted speculative tokens


def cache_capacity(cfg, max_len):
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window + SPEC_MARGIN)
    return max_len


def init_attention(gen, cfg, dtype, device):
    d, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, (H, D), dtype, device),
        "wk": dense_init(gen, d, (K, D), dtype, device),
        "wv": dense_init(gen, d, (K, D), dtype, device),
        "wo": dense_init(gen, H * D, d, dtype, device).view(H, D, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(D, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(D, dtype=dtype, device=device)
    return p


def _proj(x, w):
    """x (B, S, d) @ w (d, N, D) -> (B, S, N, D)."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])


def _project_q(p, cfg, x):
    q = _proj(x, p["wq"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(p, cfg, x):
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _project_out(p, out):
    B, S, H, D = out.shape
    return out.reshape(B, S, H * D) @ p["wo"].reshape(H * D, -1)


def attention_prefill(p, cfg, x, positions
                      ):
    """Causal prefill attention returning (output, (k, v)) to seed the cache."""
    q = rope(_project_q(p, cfg, x), positions, cfg.rope_theta)
    k, v = _project_kv(p, cfg, x)
    k = rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    return _project_out(p, out), (k, v)


def write_cache(cache_k, cache_v, kv_pos, k_new, v_new, start_pos):
    """Write T new entries at positions start_pos + [0, T), IN PLACE.

    cache_k/v (B, cap, K, D); kv_pos (B, cap); k/v_new (B, T, K, D);
    start_pos (B,).  Slot = position % cap.  (JAX donated the cache through
    this scatter; here the preallocated cache is updated in place.)
    """
    B, cap = kv_pos.shape
    T = k_new.shape[1]
    pos = start_pos[:, None].to(torch.int32) + torch.arange(T, dtype=torch.int32,
                                                            device=k_new.device)
    slots = (pos % cap).long()
    rows = torch.arange(B, device=k_new.device)[:, None]
    cache_k[rows, slots] = k_new.to(cache_k.dtype)
    cache_v[rows, slots] = v_new.to(cache_v.dtype)
    kv_pos[rows, slots] = pos


def prefill_fill_cache(k_new, v_new, lengths, cap, dtype):
    """Decode cache from right-padded (bucketed) prefill K/V, as a gather.

    For slot j the winner is the LAST real position p < lengths with
    p % cap == j.  Padded positions never reach the cache: their slots keep
    kv_pos = -1, so bucketed prefill is invisible to every later decode step.
    """
    B, S, K, D = k_new.shape
    j = torch.arange(cap, device=k_new.device)[None, :]
    wrap = torch.div(lengths.long()[:, None] - 1 - j, cap, rounding_mode="floor")
    pos_win = j + cap * wrap.clamp_min(0)
    valid = wrap >= 0
    idx = pos_win.clamp(0, S - 1)[:, :, None, None].expand(B, cap, K, D)
    m = valid[:, :, None, None]
    zero = torch.zeros((), dtype=dtype, device=k_new.device)
    ck = torch.where(m, torch.gather(k_new, 1, idx).to(dtype), zero)
    cv = torch.where(m, torch.gather(v_new, 1, idx).to(dtype), zero)
    return ck, cv, torch.where(valid, pos_win, -1).to(torch.int32)


def write_pages(pool_k, pool_v, k_new, v_new, block_tables, start_pos):
    """Scatter T new entries per row into the page pool, IN PLACE.

    pool_k/v (n_pages + 1, ps, K, D), the last page the spare; k/v_new (B, T,
    K, D); block_tables (B, P), -1 = unset; start_pos (B,).  Position p of
    row b lands in slot p % ps of page block_tables[b, p // ps].  A write
    whose entry is unset or past the table goes to the spare page (JAX's
    dropped write), so idle rows and bucket padding never touch live pages.
    """
    n_pages, ps, K, D = pool_k.shape
    n_pages -= 1
    T, P = k_new.shape[1], block_tables.shape[1]
    pos = start_pos[:, None].long() + torch.arange(T, device=k_new.device)
    pidx = pos // ps
    page = torch.gather(block_tables.long(), 1, pidx.clamp(0, P - 1))
    page = torch.where((pidx < P) & (page >= 0) & (page < n_pages), page, n_pages)
    flat = (page * ps + pos % ps).reshape(-1)
    pool_k.view(-1, K, D)[flat] = k_new.reshape(-1, K, D).to(pool_k.dtype)
    pool_v.view(-1, K, D)[flat] = v_new.reshape(-1, K, D).to(pool_v.dtype)


def attention_decode(p, cfg, x, cache,
                     cache_len, block_tables=None):
    """Decode T >= 1 new tokens; the layer's cache views are updated in place.

    ``cache`` = {"k", "v", "kv_pos"} of this layer, or its page pool {"k",
    "v"} with ``block_tables``; ``cache_len`` (B,) is the committed length
    BEFORE these tokens, so query i sits at cache_len + i.
    """
    T = x.shape[1]
    pos = cache_len[:, None].long() + torch.arange(T, device=x.device)[None, :]
    q = rope(_project_q(p, cfg, x), pos, cfg.rope_theta)
    k, v = _project_kv(p, cfg, x)
    k = rope(k, pos, cfg.rope_theta)
    if block_tables is not None:
        write_pages(cache["k"], cache["v"], k, v, block_tables, cache_len)
        out = ops.decode_attention_paged(q, cache["k"][:-1], cache["v"][:-1], cache_len + T,
                                         block_tables, window=cfg.sliding_window)
        return _project_out(p, out)
    write_cache(cache["k"], cache["v"], cache["kv_pos"], k, v, cache_len)
    out = ops.decode_attention(q, cache["k"], cache["v"], cache_len + T,
                               kv_positions=cache["kv_pos"], window=cfg.sliding_window)
    return _project_out(p, out)
