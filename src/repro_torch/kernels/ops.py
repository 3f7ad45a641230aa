"""Public kernel API with device dispatch.

A tensor on the CPU goes to the plain PyTorch version; a tensor on a CUDA
device goes to the hand-written kernel, and the call raises if the kernel
cannot take it.  There is no fallback and no switch.
"""
from __future__ import annotations


from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd


def flash_attention(q, k, v, *, causal=True, window=None,
                    q_offset=0, scale=None):
    """Prefill attention; see ``ref.flash_attention`` for shapes."""
    if q.device.type == "cpu":
        return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, scale=scale)
    return fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)


def decode_attention(q, k_cache, v_cache, cache_len, *, kv_positions=None,
                     window=None, scale=None,
                     causal=True):
    """Decode-step attention of T new tokens against a KV cache."""
    if q.device.type == "cpu":
        return da.decode_attention_plain(q, k_cache, v_cache, cache_len,
                                         kv_positions=kv_positions, window=window,
                                         scale=scale, causal=causal)
    if not causal:
        raise NotImplementedError("cross attention has no CUDA kernel yet "
                                  "(ROADMAP M9, enc-dec)")
    return da.decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                    kv_positions=kv_positions, window=window, scale=scale)


def decode_attention_paged(q, k_pages, v_pages, cache_len, block_tables, *, window=None,
                           scale=None):
    """Decode-step attention over a global page pool via per-row block tables."""
    fn = da.decode_attention_paged_plain if q.device.type == "cpu" \
        else da.decode_attention_paged_cuda
    return fn(q, k_pages, v_pages, cache_len, block_tables, window=window, scale=scale)


def ssd_scan(x, dt, A, Bm, C, *, chunk=256, initial_state=None):
    """Mamba2 SSD scan; see ``ref.ssd_scan``.  Returns (y, final state)."""
    if x.device.type == "cpu":
        return ssd.ssd_scan_plain(x, dt, A, Bm, C, chunk=chunk, initial_state=initial_state)
    return ssd.ssd_scan_cuda(x, dt, A, Bm, C, initial_state=initial_state)


# One token of the SSD recurrence: a few small torch ops on either device
# (the reference has no Pallas kernel for it either).
ssd_decode_step = ref.ssd_decode_step
