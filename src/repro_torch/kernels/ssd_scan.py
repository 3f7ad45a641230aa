"""Mamba2 SSD chunked scan: the CUDA kernels' wrappers, their autograd
Function and the plain version.

The kernels (``csrc/ssd_scan.cu``) replace the TPU kernel
``repro.kernels.ssd_scan.ssd_scan_pallas``: the decay-masked intra-chunk
quadratic form plus an (H, P, N) fp32 state carried across chunks, from an
initial state to the final one.  bfloat16 runs ``ssd_wgmma_kernel`` on the
tensor cores (chunk-parallel, the state passed across a thread-block
cluster), float32 ``ssd_kernel`` on the CUDA cores; the C entry point
decides.  The backward (``csrc/ssd_scan_bwd.cu``) is the port's counterpart
of JAX differentiating the plain scan in training: bfloat16 runs
``ssd_bwd_wgmma_kernel`` on the tensor cores (chunk-parallel, S and its
gradient passed across a cluster both ways), float32 ``ssd_bwd_kernel`` on
the CUDA cores.  ``SsdScanFn`` joins the two for autograd.  The source notes
give the bounds and the designs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, cost, ref

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
             + [ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
                 + [ctypes.c_int, ctypes.c_void_p])
CHUNK = 64  # the kernels' rows a chunk, whatever the model's chunk size

# The plain version: what the kernel computes, in PyTorch (its autograd is
# the backward's plain version).
ssd_scan_plain = ref.ssd_scan


def _check(name, x, dt, A, Bm, C, initial_state):
    """Refuse what the kernels cannot take; returns the dtype code."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    tensors = (x, dt, A, Bm, C) + (() if initial_state is None else (initial_state,))
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on x's CUDA device")
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if x.dtype not in codes or Bm.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"{name}: x, B and C must all be float32 or all bfloat16")
    if any(t.dtype != torch.float32 for t in tensors[1:3] + tensors[5:]):
        raise TypeError(f"{name}: dt, A and the initial state must be float32")
    packed = (x.stride()[2:] == (P, 1) and dt.stride(2) == 1 and A.is_contiguous()
              and Bm.stride()[2:] == (N, 1) and C.stride()[2:] == (N, 1)
              and (initial_state is None or initial_state.is_contiguous()))
    fits = ((P, N) == (64, 128) and not any(t.data_ptr() % 16 or t.stride(0) % 8
                                            or t.stride(1) % 8 for t in (x, Bm, C))
            if codes[x.dtype] else not (P % 16 or N % 16) and 16 <= P <= 64 and 16 <= N <= 128)
    if (not packed or not fits or S < 1 or dt.shape != (Bsz, S, H) or A.shape != (H,)
            or C.shape != Bm.shape or Bm.shape[:2] != (Bsz, S) or H % G
            or (initial_state is not None and initial_state.shape != (Bsz, H, P, N))):
        raise ValueError(f"{name}: unsupported layout x{tuple(x.shape)} B{tuple(Bm.shape)} "
                         "(trailing dimensions packed; bfloat16: P = 64, N = 128, 16-byte "
                         "aligned rows; float32: P and N multiples of 16, P <= 64, N <= 128)")
    return codes[x.dtype]


def _strides(x, dt, Bm, C):
    return (*x.stride()[:2], *dt.stride()[:2], *Bm.stride()[:2], *C.stride()[:2])


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
    dtype = _check("ssd_scan", x, dt, A, Bm, C, initial_state)
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    sf = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    build.launch(ssd_scan_cuda, "ssd_scan", _ARGTYPES, dtype,
                 torch.cuda.current_stream(x.device).cuda_stream, x.data_ptr(), dt.data_ptr(),
                 A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
                 None if initial_state is None else initial_state.data_ptr(), y.data_ptr(),
                 sf.data_ptr(), Bsz, S, H, G, P, N, *_strides(x, dt, Bm, C))
    return y, sf


def ssd_scan_bwd_cuda(x, dt, A, Bm, C, dy, *, initial_state=None):
    """Launch the backward on the current stream; returns the gradients of y
    (dx, ddt, dA, dB, dC): dx, dB and dC in x's dtype, ddt and dA float32.
    The forward's inputs as ``ssd_scan_cuda`` takes them (the same checks);
    dy (B, S, H, P) in x's dtype.  The final state takes no gradient.
    Workspaces, float32, alive for the call only (1.0 GB at mamba2-2.7b's
    training shape, B = 4, S = 2048): the states of each 64-row chunk (B,
    ceil(S / 64), H, P, N; 335 MB there), recomputed; dB and dC per head
    (671 MB), summed over a group's heads by a second kernel; dA's shares
    (B, H, ceil(S / 64)), one a (row, head) in float32, one a chunk in
    bfloat16 (whose kernel first keeps each chunk's decay there)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    dtype = _check("ssd_scan_bwd", x, dt, A, Bm, C, initial_state)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy{tuple(dy.shape)} {dy.dtype} must match x")
    dy = dy.contiguous()
    dev, f32 = x.device, torch.float32
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dA = torch.empty(H, dtype=f32, device=dev)
    dB, dC = (torch.empty((Bsz, S, G, N), dtype=x.dtype, device=dev) for _ in range(2))
    states = torch.empty((Bsz, -(-S // CHUNK), H, P, N), dtype=f32, device=dev)
    dBh, dCh = (torch.empty((Bsz, S, H, N), dtype=f32, device=dev) for _ in range(2))
    dA_part = torch.empty((Bsz, H, -(-S // CHUNK)), dtype=f32, device=dev)
    build.launch(ssd_scan_bwd_cuda, "ssd_scan_bwd", _BWD_ARGTYPES, dtype,
                 torch.cuda.current_stream(dev).cuda_stream,
                 *(t.data_ptr() for t in (x, dt, A, Bm, C)),
                 None if initial_state is None else initial_state.data_ptr(),
                 *(t.data_ptr() for t in (dy, dx, ddt, dA, dB, dC, states, dBh, dCh, dA_part)),
                 Bsz, S, H, G, P, N, *_strides(x, dt, Bm, C))
    return dx, ddt, dA, dB, dC


class SsdScanFn(torch.autograd.Function):
    """K4 under autograd: the forward kernel, then the backward kernel for
    the gradients of x, dt, A, B and C.  Neither state takes a gradient: one
    that reaches the final state raises here (the kernel has no term for
    it), and ``ops.ssd_scan`` refuses an initial state that requires one.
    On meta tensors (the dry run) both give empty outputs of the kernels'
    shapes; the backward reports its work (``cost.ssd`` with ``bwd``) on
    meta and CUDA alike."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, initial_state):
        if x.is_meta:
            y, sf = x.new_empty(x.shape), x.new_empty((x.shape[0], *x.shape[2:], Bm.shape[-1]),
                                                      dtype=torch.float32)
        else:
            y, sf = ssd_scan_cuda(x, dt, A, Bm, C, initial_state=initial_state)
        ctx.save_for_backward(x, dt, A, Bm, C, initial_state)
        ctx.set_materialize_grads(False)
        return y, sf

    @staticmethod
    def backward(ctx, dy, dsf):
        if dsf is not None:
            raise NotImplementedError("ssd_scan: no gradient through the final state on the "
                                      "card: K4's backward kernel has no term for it")
        x, dt, A, Bm, C, s0 = ctx.saved_tensors  # once: remat's saved-tensor hooks unpack once
        with cost.kernel("ssd_scan_bwd", cost.ssd, x, dt, A, Bm, C, bwd=True):
            if x.is_meta:
                return (*(t.new_empty(t.shape) for t in (x, dt, A, Bm, C)), None)
            return (*ssd_scan_bwd_cuda(x, dt, A, Bm, C, dy, initial_state=s0), None)


def widened(fn, x, dt, A, Bm, C, initial_state=None):
    """``fn(x, dt, A, Bm, C, initial_state)`` -> (y, final state), with a
    reduced model's bfloat16 heads (P < 64) and states (N < 128) padded with
    zeros to the tensor-core kernels' P = 64 and N = 128 and the outputs cut
    back: a zero column adds nothing to any product, and autograd carries
    the gradients through the pad and the cut."""
    P, N = x.shape[3], Bm.shape[3]
    if x.dtype != torch.bfloat16 or (P, N) == (64, 128) or P > 64 or N > 128:
        return fn(x, dt, A, Bm, C, initial_state)
    pad = torch.nn.functional.pad
    y, sf = fn(pad(x, (0, 64 - P)), dt, A, pad(Bm, (0, 128 - N)), pad(C, (0, 128 - N)),
               None if initial_state is None else pad(initial_state, (0, 128 - N, 0, 64 - P)))
    return y[..., :P], sf[:, :, :P, :N]


# every launch, and those that took the bf16 tensor-core kernel
ssd_scan_cuda.launches = ssd_scan_cuda.wgmma_launches = 0
ssd_scan_bwd_cuda.launches = ssd_scan_bwd_cuda.wgmma_launches = 0
