"""Mamba2 SSD chunked scan: the CUDA kernels' wrapper and its plain version.

The kernels (``csrc/ssd_scan.cu``) replace the TPU kernel
``repro.kernels.ssd_scan.ssd_scan_pallas``: the decay-masked intra-chunk
quadratic form plus an (H, P, N) fp32 state carried across chunks, from an
initial state to the final one.  bfloat16 runs ``ssd_wgmma_kernel`` on the
tensor cores (chunk-parallel, the state passed across a thread-block
cluster), float32 ``ssd_kernel`` on the CUDA cores; the C entry point
decides.  The source note gives the bound and the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
             + [ctypes.c_int, ctypes.c_void_p])

# The plain version: what the kernel computes, in PyTorch.
ssd_scan_plain = ref.ssd_scan


def ssd_scan_cuda(x, dt, A, Bm, C, *, initial_state=None):
    """Launch the kernel on the current stream; returns (y (B, S, H, P) in
    x's dtype, final state (B, H, P, N) fp32).

    x (B, S, H, P) and Bm, C (B, S, G, N) in one dtype (float32 or bfloat16),
    dt (B, S, H) and A (H,) float32, initial_state (B, H, P, N) float32 or
    None.  x, dt, Bm and C may be strided views over batch and sequence
    (the model passes slices of the conv output); their trailing dimensions
    must be packed.  bfloat16 takes P = 64 and N = 128 only, and x, Bm and C
    16-byte aligned with strides that are multiples of 8 elements (16-byte
    copies).  The kernels scan in 64-row chunks whatever the model's chunk
    size: the chunking moves only rounding.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    tensors = (x, dt, A, Bm, C) + (() if initial_state is None else (initial_state,))
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: every tensor must be on x's CUDA device")
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if x.dtype not in codes or Bm.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("ssd_scan: x, B and C must all be float32 or all bfloat16")
    if any(t.dtype != torch.float32 for t in tensors[1:3] + tensors[5:]):
        raise TypeError("ssd_scan: dt, A and the initial state must be float32")
    packed = (x.stride()[2:] == (P, 1) and dt.stride(2) == 1 and A.is_contiguous()
              and Bm.stride()[2:] == (N, 1) and C.stride()[2:] == (N, 1)
              and (initial_state is None or initial_state.is_contiguous()))
    fits = ((P, N) == (64, 128) and not any(t.data_ptr() % 16 or t.stride(0) % 8
                                            or t.stride(1) % 8 for t in (x, Bm, C))
            if codes[x.dtype] else not (P % 16 or N % 16) and 16 <= P <= 64 and 16 <= N <= 128)
    if (not packed or not fits or S < 1 or dt.shape != (Bsz, S, H) or A.shape != (H,)
            or C.shape != Bm.shape or Bm.shape[:2] != (Bsz, S) or H % G
            or (initial_state is not None and initial_state.shape != (Bsz, H, P, N))):
        raise ValueError(f"ssd_scan: unsupported layout x{tuple(x.shape)} B{tuple(Bm.shape)} "
                         "(trailing dimensions packed; bfloat16: P = 64, N = 128, 16-byte "
                         "aligned rows; float32: P and N multiples of 16, P <= 64, N <= 128)")
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    sf = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    build.launch(ssd_scan_cuda, "ssd_scan", _ARGTYPES, codes[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream, x.data_ptr(), dt.data_ptr(),
                 A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
                 None if initial_state is None else initial_state.data_ptr(), y.data_ptr(),
                 sf.data_ptr(), Bsz, S, H, G, P, N, *x.stride()[:2], *dt.stride()[:2],
                 *Bm.stride()[:2], *C.stride()[:2])
    return y, sf


# every launch, and those that took ssd_wgmma_kernel
ssd_scan_cuda.launches = ssd_scan_cuda.wgmma_launches = 0
