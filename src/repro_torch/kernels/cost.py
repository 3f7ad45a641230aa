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
  causal intra-chunk product, the inter-chunk term and the state update.
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


def decode(q, k, cache_len, kv_positions=None):
    B, T, H, D = q.shape
    return 4 * B * T * H * k.shape[1] * D, 2 * _size(q, k) + _size(cache_len, kv_positions)


def paged(q, k_pages, cache_len, block_tables):
    B, T, H, D = q.shape
    slots = block_tables.shape[1] * k_pages.shape[1]
    kv = 2 * B * slots * k_pages.shape[2] * D * k_pages.element_size()
    return 4 * B * T * H * slots * D, 2 * _size(q) + kv + _size(cache_len, block_tables)


def ssd(x, dt, A, Bm, C, initial_state=None, chunk=64):
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    ops = 0
    for c0 in range(0, S, chunk):
        c = min(chunk, S - c0)
        ops += 2 * c * c * N * G + c * (c + 1) * P * H + 4 * c * P * N * H
    state = B * H * P * N * 4
    return B * ops, 2 * _size(x) + _size(dt, A, Bm, C, initial_state) + state


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
