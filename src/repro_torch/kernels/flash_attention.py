"""Flash attention (prefill): the CUDA kernel's wrapper and its plain version.

The kernels (``csrc/flash_attention.cu``) replace the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``: causal or full
attention with GQA, an optional sliding window and a ``q_offset``
continuation.  bfloat16 runs ``flash_wgmma_kernel`` on the tensor cores,
float32 ``flash_kernel`` on the CUDA cores; the C entry point decides.  The
source note gives the bound and the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                                         ctypes.c_void_p]

# The plain version: what the kernel computes, in PyTorch.
flash_attention_plain = ref.flash_attention


def flash_attention_cuda(q, k, v, *, causal=True, window=None,
                         q_offset=0, scale=None):
    """Launch the kernel on the current stream; returns (B, Sq, H, D) in q's dtype.

    q (B, Sq, H, D); k, v (B, Sk, K, D) of q's dtype, all contiguous on one
    CUDA device.
    """
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    dtype = build.check_inputs("flash_attention", q, (k, v))
    if k.shape != v.shape or k.shape[::3] != (B, D) or H % K or D not in build.HEAD_DIMS:
        raise ValueError(f"flash_attention: unsupported shapes q{tuple(q.shape)} "
                         f"kv{tuple(k.shape)} (head_dim must be 32, 64, 120 or 128)")
    out = torch.empty_like(q)
    build.launch(flash_attention_cuda, "flash_attention", _ARGTYPES, dtype,
                 torch.cuda.current_stream(q.device).cuda_stream, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, K, D, int(causal),
                 -1 if window is None else window, q_offset,
                 D ** -0.5 if scale is None else scale)
    return out


# every launch, and those that took flash_wgmma_kernel
flash_attention_cuda.launches = flash_attention_cuda.wgmma_launches = 0
