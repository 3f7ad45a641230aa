"""Flash attention (prefill and training): the CUDA kernels' wrappers, their
autograd Function and the plain version.

The kernels (``csrc/flash_attention.cu``) replace the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``: causal or full
attention with GQA, an optional sliding window and a ``q_offset``
continuation.  bfloat16 runs ``flash_wgmma_kernel`` on the tensor cores,
float32 ``flash_kernel`` on the CUDA cores; the C entry point decides.  The
backward (``csrc/flash_attention_bwd.cu``) is the port's counterpart of JAX
differentiating that kernel in training: bfloat16 runs ``dkdv_wgmma_kernel``
and ``dq_wgmma_kernel`` on the tensor cores, float32 ``dkdv_kernel`` and
``dq_kernel`` on the CUDA cores; without a mask queries and keys may differ
in length (an encoder-decoder's cross attention).  ``FlashAttentionFn``
joins the two for autograd.  The source notes give the bounds and the designs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, cost, ref

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                                         ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                               ctypes.c_void_p]

# The plain version: what the kernel computes, in PyTorch.
flash_attention_plain = ref.flash_attention


def flash_attention_cuda(q, k, v, *, causal=True, window=None,
                         q_offset=0, scale=None, lse=False):
    """Launch the kernel on the current stream; returns (B, Sq, H, D) in q's
    dtype, and with ``lse`` also each row's log-sum-exp (B, H, Sq) float32.

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
    rows = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device) if lse else None
    build.launch(flash_attention_cuda, "flash_attention", _ARGTYPES, dtype,
                 torch.cuda.current_stream(q.device).cuda_stream, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), rows.data_ptr() if lse else None, B, Sq, Sk, H,
                 K, D, int(causal), -1 if window is None else window, q_offset,
                 D ** -0.5 if scale is None else scale)
    return (out, rows) if lse else out


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal=True, window=None,
                             q_offset=0, scale=None):
    """Launch the backward on the current stream; returns (dq, dk, dv) in q's
    dtype.  q, out, dout (B, Sq, H, D); k, v (B, Sk, K, D); lse (B, H, Sq)
    float32 from ``flash_attention_cuda(..., lse=True)``.  ``q_offset`` 0
    (training); Sq != Sk only without a mask (cross attention over a whole
    memory): causal or windowed, it is self-attention."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if q_offset or D not in (64, 128):
        raise ValueError(f"flash_attention_bwd: q_offset {q_offset}, head_dim {D} (it takes "
                         "q_offset 0, training's attention, and head_dim 64 or 128)")
    if Sq != Sk and (causal or window is not None):
        raise ValueError(f"flash_attention_bwd: Sq {Sq} != Sk {Sk} under a causal mask or a "
                         "window is a q_offset continuation, which training never sets")
    dtype = build.check_inputs("flash_attention_bwd", q, (k, v, out, dout))
    if (k.shape[::3] != (B, D) or v.shape != k.shape or H % K or {out.shape, dout.shape} !=
            {q.shape} or lse.shape != (B, H, Sq) or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: unsupported shapes q{tuple(q.shape)} "
                         f"kv{tuple(k.shape)} lse{tuple(lse.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    build.launch(flash_attention_bwd_cuda, "flash_attention_bwd", _BWD_ARGTYPES, dtype,
                 torch.cuda.current_stream(q.device).cuda_stream,
                 *(t.data_ptr() for t in (q, k, v, out, dout, lse, dq, dk, dv, delta)),
                 B, Sq, Sk, H, K, D, int(causal), -1 if window is None else window,
                 D ** -0.5 if scale is None else scale)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K2 under autograd: the forward kernel with its log-sum-exp, the
    backward kernel for the gradients of q, k and v.  On meta tensors (the
    dry run) both give empty outputs of the kernels' shapes; the backward
    reports its work (``cost.flash_bwd``) on meta and CUDA alike."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.is_meta:
            out, lse = q.new_empty(q.shape), q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                                                         dtype=torch.float32)
        else:
            out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale,
                                            lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = {"causal": causal, "window": window, "scale": scale}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors  # once: remat's saved-tensor hooks unpack once
        D, mask = q.shape[-1], dict(ctx.mask)
        with cost.kernel("flash_attention_bwd", cost.flash_bwd, q, k, mask["causal"],
                         mask["window"]):
            if q.is_meta:
                return (*(t.new_empty(t.shape) for t in (q, k, v)), None, None, None)
            if D == 32:  # a reduced model's heads: the backward takes head_dim 64, so zero
                # columns pad its inputs (they change no product, and lse stays) and are
                # cut from the gradients; the scale stays head_dim 32's
                q, k, v, out, dout = (torch.nn.functional.pad(t, (0, 32))
                                      for t in (q, k, v, out, dout))
                mask["scale"] = mask["scale"] or D ** -0.5
            grads = flash_attention_bwd_cuda(q, k, v, out, dout.contiguous(), lse, **mask)
        return (*(g[..., :D] for g in grads), None, None, None)


# every launch, and those that took a tensor-core kernel (bf16 forward and backward)
flash_attention_cuda.launches = flash_attention_cuda.wgmma_launches = 0
flash_attention_bwd_cuda.launches = flash_attention_bwd_cuda.wgmma_launches = 0
