"""Public kernel API with device dispatch.

A tensor on the CPU goes to the plain PyTorch version; a tensor on a CUDA
device goes to the hand-written kernel, and the call raises if the kernel
cannot take it.  A meta tensor (the dry run) gets empty outputs of the
kernel's shapes: shape propagation, nothing is computed.  A kernel call on
CUDA or meta reports its work (``kernels.cost``) to the active analyzer.
Any other device raises.  There is no fallback and no switch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cost
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd


def _on(t):
    if t.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"the port's kernels run on the CPU, CUDA or meta, not {t.device}")
    return t.device.type


def flash_attention(q, k, v, *, causal=True, window=None,
                    q_offset=0, scale=None):
    """Prefill and training attention; see ``ref.flash_attention`` for
    shapes.  On a CUDA device, a call that autograd records (an input that
    requires grad) runs ``FlashAttentionFn``: K2 forward, K2 backward."""
    if _on(q) == "cpu":
        return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, scale=scale)
    with cost.kernel("flash_attention", cost.flash, q, k, causal, window, q_offset):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            if q_offset:
                raise ValueError("flash_attention: a gradient needs q_offset 0")
            return fa.FlashAttentionFn.apply(q, k, v, causal, window, scale)
        if q.is_meta:
            return q.new_empty(q.shape)
        return fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, scale=scale)


def decode_attention(q, k_cache, v_cache, cache_len, *, kv_positions=None,
                     window=None, scale=None,
                     causal=True):
    """Decode-step attention of T new tokens against a KV cache, or (not
    ``causal``) serving's cross attention against an encoder's memory.  K1
    has no backward: on a CUDA device a call that autograd would record
    raises (training's cross attention runs K2, ``flash_attention``)."""
    if _on(q) == "cpu":
        return da.decode_attention_plain(q, k_cache, v_cache, cache_len,
                                         kv_positions=kv_positions, window=window,
                                         scale=scale, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_cache, v_cache)):
        raise NotImplementedError("decode_attention: K1 has no backward kernel, so a gradient "
                                  "through it cannot run on the card (training's attention, "
                                  "cross attention too, runs K2: flash_attention)")
    with cost.kernel("decode_attention", cost.decode, q, k_cache, cache_len, kv_positions):
        return q.new_empty(q.shape) if q.is_meta else da.decode_attention_cuda(
            q, k_cache, v_cache, cache_len, kv_positions=kv_positions, window=window,
            scale=scale, causal=causal)


def decode_attention_paged(q, k_pages, v_pages, cache_len, block_tables, *, window=None,
                           scale=None):
    """Decode-step attention over a global page pool via per-row block tables."""
    if _on(q) == "cpu":
        return da.decode_attention_paged_plain(q, k_pages, v_pages, cache_len, block_tables,
                                               window=window, scale=scale)
    with cost.kernel("decode_attention_paged", cost.paged, q, k_pages, cache_len, block_tables):
        return q.new_empty(q.shape) if q.is_meta else da.decode_attention_paged_cuda(
            q, k_pages, v_pages, cache_len, block_tables, window=window, scale=scale)


def ssd_scan(x, dt, A, Bm, C, *, chunk=256, initial_state=None):
    """Mamba2 SSD scan; see ``ref.ssd_scan``.  Returns (y, final state).  On
    a CUDA device, a call that autograd records runs ``SsdScanFn``: K4
    forward, K4 backward; neither state takes a gradient there."""
    if _on(x) == "cpu":
        return ssd.ssd_scan_plain(x, dt, A, Bm, C, chunk=chunk, initial_state=initial_state)
    with cost.kernel("ssd_scan", cost.ssd, x, dt, A, Bm, C, initial_state):
        if x.is_meta:  # empty outputs (under autograd, an empty backward); nothing to pad
            return ssd.SsdScanFn.apply(x, dt, A, Bm, C, initial_state)
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in (x, dt, A, Bm, C, initial_state)):
            if initial_state is not None and initial_state.requires_grad:
                raise NotImplementedError("ssd_scan: no gradient for the initial state on the "
                                          "card: K4's backward kernel has no term for it")
            return ssd.widened(ssd.SsdScanFn.apply, x, dt, A, Bm, C, initial_state)
        return ssd.ssd_scan_cuda(x, dt, A, Bm, C, initial_state=initial_state)


# One token of the SSD recurrence: a few small torch ops on either device
# (the reference has no Pallas kernel for it either).
ssd_decode_step = ref.ssd_decode_step
