"""Decode attention: the CUDA kernels' wrappers and their plain versions.

``csrc/decode_attention.cu`` replaces the TPU kernel
``repro.kernels.decode_attention.decode_attention_pallas``: flash-decode of
T new tokens (1 for decode, depth+1 for verify) against a dense or ring KV
cache with positional masking from ``kv_positions``, and (not ``causal``)
an encoder-decoder's cross attention, which the reference runs in its plain
version.
``csrc/decode_attention_paged.cu`` replaces ``decode_attention_paged_pallas``:
the same over a global page pool through per-row block tables, at decode
sizes and at paged admission's T up to max_context.  In both, the C entry
point sends every bfloat16 call to a tensor-core kernel with split-KV
(``decode_wgmma_kernel``, ``paged_wgmma_kernel``) and float32 to a CUDA-core
kernel (``decode_kernel``, ``paged_decode_kernel``).  Each source note gives
the bound and the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# the C entry point decode_attention_masked; decode_attention, the same with
# causal = 1, takes _ARGTYPES (attention_variants.py calls it)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                                         ctypes.c_void_p]
_MASKED_ARGTYPES = _ARGTYPES[:13] + [ctypes.c_int] + _ARGTYPES[13:]
_PAGED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                                               ctypes.c_void_p]

# The plain versions: what the kernels compute, in PyTorch.
decode_attention_plain = ref.decode_attention
decode_attention_paged_plain = ref.decode_attention_paged


def dense_positions(cache_len, S):
    """(B, S) int32 positions of a dense cache: slot i holds position i while
    i < cache_len, else -1 (what the plain version assumes without
    ``kv_positions``)."""
    pos = torch.arange(S, dtype=torch.int32, device=cache_len.device)[None]
    return torch.where(pos < cache_len[:, None], pos, -1).to(torch.int32)


def decode_attention_cuda(q, k_cache, v_cache, cache_len, *, kv_positions=None,
                          window=None, scale=None, causal=True):
    """Launch the kernel on the current stream; returns (B, T, H, D) in q's dtype.

    q (B, T, H, D); k/v_cache (B, S, K, D) of q's dtype; cache_len (B,) int32
    (the T new tokens included; not ``causal``: the memory's valid length);
    kv_positions (B, S) int32, or None for a dense cache whose slot i holds
    position i while i < cache_len.  None builds those positions on the
    device on every call; the serving path passes the cache's own
    ``kv_pos`` (cross attention the ``mem_pos`` built once at prefill), and
    that is how the kernel is timed and served.  Not ``causal``, every query
    sees every slot with a position >= 0; a window is then refused.
    """
    B, T, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    if kv_positions is None:
        kv_positions = dense_positions(cache_len, S)
    dtype = build.check_inputs("decode_attention", q, (k_cache, v_cache),
                               (cache_len, kv_positions))
    if (k_cache.shape != v_cache.shape or k_cache.shape[::3] != (B, D) or H % K
            or D not in build.HEAD_DIMS or cache_len.shape != (B,)
            or kv_positions.shape != (B, S)):
        raise ValueError(f"decode_attention: unsupported shapes q{tuple(q.shape)} "
                         f"kv{tuple(k_cache.shape)} (head_dim must be 32, 64, 120 or 128)")
    if window is not None and not causal:
        raise ValueError("decode_attention: cross attention (causal=False) takes no window")
    out = torch.empty_like(q)
    build.launch(decode_attention_cuda, "decode_attention", _MASKED_ARGTYPES, dtype,
                 torch.cuda.current_stream(q.device).cuda_stream, q.data_ptr(),
                 k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
                 kv_positions.data_ptr(), out.data_ptr(), B, T, H, K, D, S,
                 -1 if window is None else window, int(causal),
                 D ** -0.5 if scale is None else scale, symbol="decode_attention_masked")
    return out


# every launch, and those that took decode_wgmma_kernel
decode_attention_cuda.launches = decode_attention_cuda.wgmma_launches = 0


def decode_attention_paged_cuda(q, k_pages, v_pages, cache_len, block_tables, *,
                                window=None, scale=None):
    """Launch the paged kernel on the current stream; returns (B, T, H, D).

    q (B, T, H, D); k/v_pages (n_pages, ps, K, D) of q's dtype; cache_len (B,)
    int32 (the T new tokens included); block_tables (B, P) int32, -1 = unset.
    """
    B, T, H, D = q.shape
    n_pages, ps, K = k_pages.shape[:3]
    P = block_tables.shape[1]
    dtype = build.check_inputs("decode_attention_paged", q, (k_pages, v_pages),
                               (cache_len, block_tables))
    if (k_pages.shape != v_pages.shape or k_pages.shape[3] != D or H % K
            or D not in build.HEAD_DIMS or cache_len.shape != (B,)
            or block_tables.shape[0] != B):
        raise ValueError(f"decode_attention_paged: unsupported shapes q{tuple(q.shape)} "
                         f"pages{tuple(k_pages.shape)} (head_dim must be 32, 64, 120 or 128)")
    out = torch.empty_like(q)
    build.launch(decode_attention_paged_cuda, "decode_attention_paged", _PAGED_ARGTYPES, dtype,
                 torch.cuda.current_stream(q.device).cuda_stream, q.data_ptr(),
                 k_pages.data_ptr(), v_pages.data_ptr(), cache_len.data_ptr(),
                 block_tables.data_ptr(), out.data_ptr(), B, T, H, K, D, n_pages, ps, P,
                 -1 if window is None else window, D ** -0.5 if scale is None else scale)
    return out


# every launch, and those that took paged_wgmma_kernel
decode_attention_paged_cuda.launches = decode_attention_paged_cuda.wgmma_launches = 0
