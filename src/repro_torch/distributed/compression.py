"""int8 gradient compression with error feedback (a port of
``repro.distributed.compression``).

A data-parallel all-reduce over a slow link carries each large gradient as
int8 with one fp32 scale a row, and the quantisation residual is carried
into the next step (error feedback), which keeps SGD unbiased to first
order.  On one device only the numerics change: each gradient takes the
int8 round trip that the wire format would give it.  The arithmetic is the
reference's, in its order (``max |g| / 127`` floored at 1e-12, rounding half
to even, a clip to +-127), so the results are bit-equal to it.
"""
from __future__ import annotations

import torch

from repro_torch.params import tree_items, tree_map

MIN_SIZE = 4096  # smaller tensors stay as they are (their scales would dominate)


class GradientCompressor:
    """Stateless int8 compressor; the error tree threads through the train
    step beside the optimizer state: ``grads, err = c.compress_decompress(grads, err)``."""

    def init_error(self, params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def compress_decompress(self, grads, error):
        """Each gradient of at least ``MIN_SIZE`` elements plus its carried
        error, quantised per row (last axis) to int8 and back.  Leaf by leaf
        and in place: the gradient takes the dequantised value, the error the
        new residual, so no whole-model temporary is held.  Returns (grads,
        error)."""
        errors = dict(tree_items(error))
        for path, g in tree_items(grads):
            if g.numel() >= MIN_SIZE and g.dim():
                gf = errors[path].add_(g)  # g + e in fp32, held in e until the residual
                scale = gf.abs().amax(-1, keepdim=True).div_(127.0).clamp_min_(1e-12)
                deq = torch.round(gf / scale).clamp_(-127, 127).to(torch.int8).float().mul_(scale)
                g.copy_(deq)
                gf.sub_(deq)
        return grads, error

    def wire_bytes(self, grads):
        """(uncompressed, compressed) bytes of the gradients on the wire: int8
        and a float32 scale a row for each compressed leaf."""
        sizes = [(g.numel(), g.shape[-1] if g.dim() else 1) for _, g in tree_items(grads)]
        return sum(n * 4 for n, _ in sizes), sum(
            n * 4 if n < MIN_SIZE else n + n // row * 4 for n, row in sizes)
