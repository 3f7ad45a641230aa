"""Each kernel's own work, from its inputs' shapes alone: (FLOPs, bytes),
the bytes each input read once and each output written once.  The wrappers
in ``kernels.ops`` report it to the active analyzer (``launch.op_analysis``)
for a meta tensor (the dry run: nothing is computed) and for a CUDA launch
alike, so a step counts the same on both; the ops inside a wrapper are not
counted again.

* K1 walks every slot of its cache (``decode_attention``);
* K2 counts the (query, key) pairs its causal mask and window leave;
* K3 reads every page its block table has room for;
* K4 runs the chunked dual form at its 64-row chunks: C.B per group, the
  causal intra-chunk product, the inter-chunk term and the state update;
* K2's backward (``flash_bwd``): its two passes' seven products over K2's
  pairs (S and dP twice: the dQ pass recomputes them); q, k, v, out, dout
  and lse read once, dq, dk and dv written once;
* K4's backward (``ssd`` with ``bwd``): C.B a group, and a head's dy.x over the
  causal half, the transposed intra-chunk forms of dx, dB and dC, their
  three terms through the state or its gradient, the gradient's step back
  and the recomputed state update; x, dt, A, B, C and dy read once, dx,
  ddt, dA, dB and dC written once.

The counting rule: a kernel's FLOPs are two a multiply-add of the products
it runs (what its source notes bound), its bytes each input read once and
each output written once; workspaces are not counted.
"""
from __future__ import annotations

import contextlib

import numpy as np

ANALYZERS = []  # the active analyzers, innermost last


def _size(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def flash(q, k, causal=True, window=None, q_offset=0):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    p = np.arange(Sq) + q_offset
    hi = np.minimum(Sk - 1, p) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, p - window + 1) if causal and window is not None else 0
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    return 4 * B * H * pairs * D, 2 * _size(q, k)


def flash_bwd(q, k, causal=True, window=None):
    flops, nbytes = flash(q, k, causal, window)  # two products; q, k, v, out
    return 7 * flops // 2, 2 * nbytes + 4 * q.numel() // q.shape[3]


def decode(q, k, cache_len, kv_positions=None):
    B, T, H, D = q.shape
    return 4 * B * T * H * k.shape[1] * D, 2 * _size(q, k) + _size(cache_len, kv_positions)


def paged(q, k_pages, cache_len, block_tables):
    B, T, H, D = q.shape
    slots = block_tables.shape[1] * k_pages.shape[1]
    kv = 2 * B * slots * k_pages.shape[2] * D * k_pages.element_size()
    return 4 * B * T * H * slots * D, 2 * _size(q) + kv + _size(cache_len, block_tables)


def ssd(x, dt, A, Bm, C, initial_state=None, chunk=64, bwd=False):
    """K4's work, or with ``bwd`` its backward's."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    ops = 0
    for c0 in range(0, S, chunk):
        c = min(chunk, S - c0)
        ops += 2 * c * c * N * G + (H * (2 * c * (c + 1) * (P + N) + 10 * c * P * N) if bwd else
                                    c * (c + 1) * P * H + 4 * c * P * N * H)
    if bwd:
        return B * ops, 3 * _size(x) + 4 * _size(Bm) + 2 * B * S * H * 4 + 2 * H * 4
    return B * ops, 2 * _size(x) + _size(dt, A, Bm, C, initial_state) + B * H * P * N * 4


@contextlib.contextmanager
def kernel(name, work, *args, **kw):
    """Report ``work(*args, **kw)`` as one call of kernel ``name`` to the
    active analyzer and count none of the ops the body runs."""
    a = ANALYZERS[-1] if ANALYZERS else None
    if a is None:
        yield
        return
    a.add_kernel(name, *work(*args, **kw))
    a.paused += 1
    try:
        yield
    finally:
        a.paused -= 1
