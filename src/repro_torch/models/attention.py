"""GQA attention with RoPE, qk-norm, QKV bias and a dense ring-buffer or
paged KV cache, and cross attention against an encoder's memory (a port of
``repro.models.attention``).  The reference pads
query heads for its 16-way model axis and masks the pad heads before ``wo``;
one card has no model axis, so the port runs the unpadded heads (the weight
bridge drops the pad slots), which computes the same function.

Dense cache per attention layer: ``k``/``v`` (B, cap, K, D) and ``kv_pos``
(B, cap) int32, the absolute position written into each slot (-1 = empty).
Slots are addressed ``pos % cap``.  Speculative rollback leaves stale slots
behind; the positional mask makes them unreachable until overwritten.

Under a mesh with a "model" axis larger than 1 (``distributed.use_mesh``)
the dense or ring cache is sharded along its slots over that axis, as the
reference's context-parallel decode shards it: each rank holds its data
shard's rows and cap / n_model slots, and decode merges the ranks' partial
attention with one log-sum-exp (``_decode_attention_cp``).  With the
weights sharded too (``shard_params`` under ``INFERENCE_RULES``) the layer
is tensor parallel: ``wq`` holds this rank's query heads
(``sharding.head_range``), ``wk``/``wv`` its KV heads or all of them where
the spec holds them whole, ``wo`` is row parallel and summed over "model".
Prefill runs K2 on the rank's heads and gathers the KV heads for the cache
(training runs the same layer under autograd, ``collectives.model_copy``
at each entry into the rank's heads);
decode gathers the new tokens' query heads (in the reference's padded slot
order), runs the context-parallel decode over every head on the rank's
slots and keeps its own heads for ``wo``.

Paged cache per attention layer: a global pool ``k``/``v`` (n_pages + 1, ps,
K, D) shared by every row through (B, P) block tables.  The last page is a
spare that absorbs the writes JAX drops (``mode="drop"``), so the scatter
needs no host sync; attention sees only the first n_pages.
"""
from __future__ import annotations


import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import (context_parallel_decode_attention,
                                                 model_copy, model_gather, model_rank, model_split,
                                                 model_sum)
from repro_torch.distributed.sharding import current_mesh, head_range, mesh_sizes
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rms_norm, rope

SPEC_MARGIN = 32  # ring-buffer slack for uncommitted speculative tokens


def cache_capacity(cfg, max_len):
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window + SPEC_MARGIN)
    return max_len


def init_attention(gen, cfg, dtype, device, cross=False):
    """A cross-attention layer (``cross``) has no QKV bias and no qk-norm,
    whatever the config says."""
    d, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, (H, D), dtype, device),
        "wk": dense_init(gen, d, (K, D), dtype, device),
        "wv": dense_init(gen, d, (K, D), dtype, device),
        "wo": dense_init(gen, H * D, d, dtype, device).view(H, D, d),
    }
    if cfg.qkv_bias and not cross:  # zeros, as the reference's init
        p["bq"] = torch.zeros(H, D, dtype=dtype, device=device)
        p["bk"] = torch.zeros(K, D, dtype=dtype, device=device)
        p["bv"] = torch.zeros(K, D, dtype=dtype, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones(D, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(D, dtype=dtype, device=device)
    return p


def _proj(x, w):
    """x (B, S, d) @ w (d, N, D) -> (B, S, N, D)."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, S, w.shape[1], w.shape[2])


def _project_q(p, cfg, x):
    sharded = cfg is not None and model_split(p["wq"].shape[1], cfg.n_heads)[2]
    q = _proj(model_copy(x, sharded), p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if "q_norm" in p:  # whole, on the rank's heads
        q = rms_norm(q, model_copy(p["q_norm"], sharded), cfg.norm_eps)
    return q


def _project_kv(p, cfg, x):
    sharded = cfg is not None and model_split(p["wk"].shape[1], cfg.n_kv_heads)[2]
    x = model_copy(x, sharded)
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if "k_norm" in p:
        k = rms_norm(k, model_copy(p["k_norm"], sharded), cfg.norm_eps)
    return k, v


def _project_out(p, cfg, out):
    B, S, H, D = out.shape
    y = out.reshape(B, S, H * D) @ p["wo"].reshape(H * D, -1)
    return model_sum(y, cfg is not None and model_split(H, cfg.n_heads)[2])


def _heads(p, cfg):
    """(h0, h1, kv whole): the query heads [h0, h1) this rank's ``wq``
    holds, and whether they are a shard while ``wk``/``wv`` hold every KV
    head (the layer then takes the KV heads its queries read).  Cross
    attention may run with no config (``cfg`` None), and then on whole
    weights."""
    n, j, sharded = model_split(p["wq"].shape[1], cfg.n_heads if cfg else p["wq"].shape[1])
    if not sharded:
        return 0, p["wq"].shape[1], False
    h0, h1 = head_range(cfg, n, j)
    return h0, h1, not model_split(p["wk"].shape[1], cfg.n_kv_heads)[2]


def _local_kv(cfg, k, v, h0, h1, whole):
    """The KV heads that query heads [h0, h1) read, out of all of them
    (``whole``; else k and v are theirs already)."""
    if not whole:
        return k, v
    k, v = model_copy(k), model_copy(v)  # under autograd: each rank's share of their gradient
    G = cfg.n_heads // cfg.n_kv_heads
    k0, k1 = h0 // G, -(-h1 // G)
    if k1 - k0 > 1 and (h0 % G or h1 % G):
        raise ValueError(f"tensor parallel attention: query heads [{h0}, {h1}) do not group "
                         f"over KV heads [{k0}, {k1})")
    return k[:, :, k0:k1], v[:, :, k0:k1]


def attention_full(p, cfg, x, positions, causal=True):
    """Training or encoder forward over a full sequence: prefill's
    attention without seeding a cache."""
    return attention_prefill(p, cfg, x, positions, causal)[0]


def attention_prefill(p, cfg, x, positions, causal=True):
    """Prefill attention returning (output, (k, v)) to seed the cache:
    causal under the config's window, or (an encoder) neither."""
    q = rope(_project_q(p, cfg, x), positions, cfg.rope_theta)
    k, v = _project_kv(p, cfg, x)
    k = rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, *_local_kv(cfg, k, v, *_heads(p, cfg)), causal=causal,
                              window=cfg.sliding_window if causal else None)
    return _project_out(p, cfg, out), (k, v)


def cross_memory(p, cfg, enc_out):
    """A decoder layer's cross-attention K and V of the encoder output
    (B, M, d): (B, M, K, D) each, computed once at prefill."""
    return _project_kv(p, cfg, enc_out)


def attention_cross(p, cfg, x, mem_k, mem_v, mem_len=None, mem_pos=None):
    """Cross attention of x (B, T, d) against the encoder memory mem_k/mem_v
    (B, M, K, D), no RoPE.  Without ``mem_pos`` the memory is whole (training
    and ``forward``): K2 with no mask, which has a backward.  Prefill and
    decode pass ``mem_len`` and the slots ``mem_pos`` (B, M) marks valid
    (``dense_positions(mem_len, M)``, built once by the caller): K1."""
    q = _project_q(p, cfg, x)
    mem_k, mem_v = _local_kv(cfg, mem_k, mem_v, *_heads(p, cfg))
    if mem_pos is None:
        out = ops.flash_attention(q, mem_k, mem_v, causal=False)
    else:
        out = ops.decode_attention(q, mem_k, mem_v, mem_len, kv_positions=mem_pos, causal=False)
    return _project_out(p, cfg, out)


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


def prefill_fill_cache(k_new, v_new, lengths, cap, dtype, lo=0, n=None):
    """Decode cache slots [lo, lo + n) (default all ``cap``) from
    right-padded (bucketed) prefill K/V, as a gather.

    For slot j the winner is the LAST real position p < lengths with
    p % cap == j.  Padded positions never reach the cache: their slots keep
    kv_pos = -1, so bucketed prefill is invisible to every later decode step.
    """
    B, S, K, D = k_new.shape
    n = cap if n is None else n
    j = torch.arange(lo, lo + n, device=k_new.device)[None, :]
    wrap = torch.div(lengths.long()[:, None] - 1 - j, cap, rounding_mode="floor")
    pos_win = j + cap * wrap.clamp_min(0)
    valid = wrap >= 0
    idx = pos_win.clamp(0, S - 1)[:, :, None, None].expand(B, n, K, D)
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


def _cp_mesh():
    """The active mesh, if its "model" axis is larger than 1."""
    mesh = current_mesh()
    return mesh if mesh_sizes(mesh or {}).get("model", 1) > 1 else None


def _write_held(cache, k_new, v_new, pos):
    """Write the new tokens whose slot falls in this rank's range [0, S) of
    its cache, in place, with no host sync: a token outside it repeats its
    row's first held write (a row with none rewrites one slot's own value),
    so every index is written with one value."""
    n, j = model_rank()
    S, T = cache["k"].shape[1], pos.shape[1]
    slot = pos % (S * n) - j * S
    held = (slot >= 0) & (slot < S)
    src = torch.where(held, torch.arange(T, device=pos.device), held.int().argmax(1, True))
    dst = slot.gather(1, src).clamp(0, S - 1)
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    keep = held.any(1)
    for key, new in (("k", k_new), ("v", v_new), ("kv_pos", pos)):
        c = cache[key]
        val = new[rows, src].to(c.dtype)
        c[rows, dst] = torch.where(keep.view(-1, *[1] * (val.dim() - 1)), val, c[rows, dst])


def _decode_attention_cp(mesh, cfg, q, k_new, v_new, cache, cache_len):
    """Context-parallel decode on this rank's slots [j S, (j + 1) S) of the
    ring (j its model index, S = cap / n_model): the new K/V (every KV head)
    and positions are written in place where their slot falls in its range
    (a verify's tokens may straddle two ranks' ranges), then fp32 partial
    attention over every query head, the window folded into the mask,
    merged over the model axis with one log-sum-exp
    (``collectives.lse_merge``).  Query heads that are a shard (tensor
    parallel) are gathered in the reference's padded slot order first, and
    the rank's own kept after."""
    T = q.shape[1]
    pos = cache_len[:, None].long() + torch.arange(T, device=q.device)
    _write_held(cache, k_new, v_new, pos)
    h = q.shape[2]
    n, j, sharded = model_split(h, cfg.n_heads)
    if sharded:
        m, Gp, G = cfg.padded_heads // n, cfg.padded_group, cfg.n_heads // cfg.n_kv_heads
        real = torch.tensor([s for s in range(m) if (j * m + s) % Gp < G], device=q.device)
        if h < m:
            q = q.new_zeros((*q.shape[:2], m, q.shape[3])).index_copy_(2, real, q)
        q = model_gather(q, 2)
    out = context_parallel_decode_attention(q, cache["k"], cache["v"], cache["kv_pos"],
                                            cache_len + T, "model", window=cfg.sliding_window)
    if sharded:
        out = out[:, :, j * m:(j + 1) * m].index_select(2, real)
    return out


def attention_decode(p, cfg, x, cache,
                     cache_len, block_tables=None):
    """Decode T >= 1 new tokens; the layer's cache views are updated in place.

    ``cache`` = {"k", "v", "kv_pos"} of this layer, or its page pool {"k",
    "v"} with ``block_tables``; ``cache_len`` (B,) is the committed length
    BEFORE these tokens, so query i sits at cache_len + i.  A dense cache
    under a context-parallel mesh takes ``_decode_attention_cp``; a paged one
    keeps K3, as in the reference.
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
        return _project_out(p, cfg, out)
    mesh = _cp_mesh()
    if mesh is not None:
        if model_split(k.shape[2], cfg.n_kv_heads)[2]:  # the cache holds every KV head
            k, v = model_gather(k, 2), model_gather(v, 2)
        return _project_out(p, cfg, _decode_attention_cp(mesh, cfg, q, k, v, cache, cache_len))
    write_cache(cache["k"], cache["v"], cache["kv_pos"], k, v, cache_len)
    out = ops.decode_attention(q, cache["k"], cache["v"], cache_len + T,
                               kv_positions=cache["kv_pos"], window=cfg.sliding_window)
    return _project_out(p, cfg, out)
