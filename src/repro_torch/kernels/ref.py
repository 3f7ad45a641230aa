"""Plain PyTorch kernels (a port of ``repro.kernels.ref``'s attention and SSD).

These run every attention and SSD-scan call on the CPU and are what the CUDA
kernels are held against on the card.  Conventions: q (B, Sq, H, D); k, v (B, Sk, K, D)
with H = K * G; all attention math accumulates in float32 whatever the input
dtype, and masked scores are ``NEG_INF`` (never -inf, so a fully masked row
stays finite: it averages the values, exactly as the TPU kernels do).
"""
from __future__ import annotations


import torch

NEG_INF = -1e30


def _attend(q, k, v, mask, scale):
    """Masked GQA softmax attention; ``mask`` broadcasts to (B, 1, 1, Sq, Sk)."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qf = q.reshape(B, Sq, K, H // K, D).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _mask(q_pos, k_pos, causal, window):
    """Visibility of key positions (..., 1, Sk) to query positions (..., Sq, 1)."""
    mask = torch.ones_like(q_pos >= k_pos)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def attention_naive(q, k, v, *, causal=True, window=None,
                    q_offset=0, scale=None):
    """O(Sq*Sk) dense attention.  ``q_offset`` is the absolute position of
    q[0] (a query block at the end of a longer KV)."""
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    return _attend(q, k, v, _mask(q_pos, k_pos, causal, window), scale)


def flash_attention(q, k, v, *, causal=True, window=None,
                    q_offset=0, q_chunk=1024,
                    scale=None):
    """``attention_naive`` over query chunks of ``q_chunk`` rows, so the score
    memory on the CPU stays (q_chunk, Sk) per head."""
    return torch.cat([
        attention_naive(q[:, i:i + q_chunk], k, v, causal=causal, window=window,
                        q_offset=q_offset + i, scale=scale)
        for i in range(0, q.shape[1], q_chunk)], dim=1)


def decode_attention(q, k_cache, v_cache, cache_len, *, kv_positions=None,
                     window=None, scale=None,
                     causal=True):
    """Attention of T new tokens against a (padded / ring-buffer) KV cache.

    q (B, T, H, D); k/v_cache (B, S, K, D); cache_len (B,) int32 is the valid
    length with the T new tokens already written, so query t sits at
    position ``cache_len - T + t``.  ``kv_positions`` (B, S) holds the
    absolute position written into each slot (-1 = empty); without it slot i
    holds position i.  ``causal=False`` (cross attention) lets every query
    see every valid slot.
    """
    T, S = q.shape[1], k_cache.shape[1]
    dev = q.device
    q_pos = cache_len.long()[:, None, None] - T + torch.arange(T, device=dev)[None, :, None]
    if kv_positions is None:
        kv_pos = torch.arange(S, device=dev)[None, None, :]
        valid = kv_pos < cache_len.long()[:, None, None]
    else:
        kv_pos = kv_positions.long()[:, None, :]
        valid = kv_pos >= 0
    mask = valid & _mask(q_pos, kv_pos, causal, window)        # (B, T, S)
    return _attend(q, k_cache, v_cache, mask[:, None, None], scale)


def decode_attention_paged(q, k_pages, v_pages, cache_len, block_tables, *,
                           window=None, scale=None):
    """``decode_attention`` over a global page pool through per-row block tables.

    k/v_pages (n_pages, ps, K, D); block_tables (B, P) page ids, -1 = unset.
    Each row's pages are gathered into a dense (B, P*ps) view (-1 clamps to
    page 0); slot s of table index i holds position i*ps + s (positions are
    written once, never wrapped), and an unset entry masks its whole page.
    """
    n_pages, ps, K, D = k_pages.shape
    B, P = block_tables.shape
    dev = q.device
    idx = (block_tables.long().clamp(0, n_pages - 1)[:, :, None] * ps
           + torch.arange(ps, device=dev)).reshape(B, P * ps)
    k = k_pages.reshape(n_pages * ps, K, D)[idx]
    v = v_pages.reshape(n_pages * ps, K, D)[idx]
    kv_pos = torch.where(block_tables.repeat_interleave(ps, dim=1) >= 0,
                         torch.arange(P * ps, dtype=torch.int32, device=dev), -1)
    return decode_attention(q, k, v, cache_len, kv_positions=kv_pos, window=window,
                            scale=scale)


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality) — chunked scan and the decode recurrence
# ---------------------------------------------------------------------------


def ssd_scan(x, dt, A, Bm, C, *, chunk=256, initial_state=None):
    """Chunked SSD forward (Mamba-2, arXiv:2405.21060 §6), all in float32.

    x (B, S, H, P); dt (B, S, H), already softplus'ed; A (H,) negative;
    Bm, C (B, S, G, N); initial_state (B, H, P, N) or None (zeros).
    Returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N) fp32.
    The last chunk is padded with dt = 0 rows, which leave the state as is.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    rep = H // G
    chunk = min(chunk, S)
    pad = (-S) % chunk
    nc = (S + pad) // chunk

    def split(t):  # (B, S, ...) -> (B, nc, chunk, ...) fp32, zero-padded
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, nc, chunk, *t.shape[2:])

    xf, dtf, Bf, Cf = split(x), split(dt), split(Bm), split(C)
    dA_cs = torch.cumsum(dtf * A.float(), dim=2)                      # (B,nc,c,H)
    # intra-chunk: decay exp(cs_i - cs_j) for j <= i, computed directly
    seg = dA_cs.transpose(2, 3)[..., :, None] - dA_cs.transpose(2, 3)[..., None, :]
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(causal, seg, NEG_INF))                  # (B,nc,H,c,c)
    CB = torch.einsum("bucgn,busgn->bugcs", Cf, Bf).repeat_interleave(rep, dim=2)
    M = CB * L * dtf.transpose(2, 3)[:, :, :, None, :]               # weight dt_j
    y = torch.einsum("buhcs,bushp->buchp", M, xf)
    # each chunk's own state contribution, then the recurrence over chunks
    decay_to_end = torch.exp(dA_cs[:, :, -1:] - dA_cs)                # (B,nc,c,H)
    states = torch.einsum("bushn,bushp->buhpn", Bf.repeat_interleave(rep, dim=3),
                          xf * (dtf * decay_to_end)[..., None])
    chunk_decay = torch.exp(dA_cs[:, :, -1])                          # (B,nc,H)
    s = (torch.zeros(Bsz, H, P, N, device=x.device) if initial_state is None
         else initial_state.float())
    before = []
    for u in range(nc):
        before.append(s)
        s = s * chunk_decay[:, u, :, None, None] + states[:, u]
    Cr = Cf.repeat_interleave(rep, dim=3) * torch.exp(dA_cs)[..., None]
    y = y + torch.einsum("buchn,buhpn->buchp", Cr, torch.stack(before, 1))
    return y.reshape(Bsz, S + pad, H, P)[:, :S].to(x.dtype), s


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, out=None):
    """One token of the SSD recurrence for decode.

    state (B, H, P, N) fp32; x_t (B, H, P); dt_t (B, H); B_t, C_t (B, G, N).
    Returns (new_state, y_t (B, H, P) in x_t's dtype); the new state is
    written into ``out`` when given (a view of the cache: no extra copy).
    """
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.float().repeat_interleave(rep, dim=1)
    Ch = C_t.float().repeat_interleave(rep, dim=1)
    dtf = dt_t.float()
    decay = torch.exp(dtf * A[None, :])
    new = torch.addcmul(state * decay[..., None, None],
                        (x_t.float() * dtf[..., None])[..., None], Bh[:, :, None, :], out=out)
    return new, torch.einsum("bhpn,bhn->bhp", new, Ch).to(x_t.dtype)
