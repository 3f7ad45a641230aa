"""int8 gradient compression with error feedback (a port of
``repro.distributed.compression``).

A data-parallel all-reduce over a slow link carries each large gradient as
int8 with one fp32 scale a row, and the quantisation residual is carried
into the next step (error feedback), which keeps SGD unbiased to first
order.  On one device only the numerics change: each gradient takes the
int8 round trip that the wire format would give it.  The arithmetic is the
reference's, in its order (``max |g| / 127`` floored at 1e-12, rounding half
to even, a clip to +-127), so the results are bit-equal to it.

Which gradients take the round trip is the reference's choice on its
leaves: a layer's leaf is stacked with the same leaf of its like layers
(``optimizer._stacks``), and a stack of fewer than ``MIN_SIZE`` elements
passes through (:func:`compression_plan`).  Under a mesh each gradient is
the rank's shard on the optimizer's piece, after the reduction over the
batch axes; a row split over mesh axes takes its scale from the max over
the whole row (a MAX all-reduce over those axes, exact in any order).
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.collectives import all_max
from repro_torch.params import tree_items, tree_map
from repro_torch.training.optimizer import _stacks, _whole

MIN_SIZE = 4096  # smaller tensors stay as they are (their scales would dominate)


def compression_plan(tree, scan_block=1, layout=None):
    """Each leaf's part in the round trip, in ``tree_items`` order: None
    where it passes through (its stack, or the leaf alone outside the
    layers, has fewer than ``MIN_SIZE`` elements or no axis), else the mesh
    axes its last axis is split over (``layout``'s ``Shard.dims[-1]``; none
    without a mesh).  ``scan_block``: the model's."""
    shards = _whole(tree, layout)
    plan = [None] * len(shards)
    for stack in _stacks(tree, scan_block):
        if sum(math.prod(shards[i].shape) for i in stack) >= MIN_SIZE:
            for i in stack:
                if shards[i].shape:
                    plan[i] = shards[i].dims[-1]
    return plan


class GradientCompressor:
    """Stateless int8 compressor; the error tree threads through the train
    step beside the optimizer state: ``grads, err = c.compress_decompress(grads,
    err, plan)``, the plan decided once (:func:`compression_plan`; without
    one, the plan of ``grads`` itself: its layers stacked as at
    ``scan_block`` 1, on no mesh)."""

    def init_error(self, params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def compress_decompress(self, grads, error, plan=None):
        """Each gradient the plan compresses plus its carried error,
        quantised per row (last axis) to int8 and back.  Leaf by leaf and in
        place: the gradient takes the dequantised value, the error the new
        residual, so no whole-model temporary is held.  Returns (grads,
        error)."""
        errors = dict(tree_items(error))
        for (path, g), axes in zip(tree_items(grads), plan or compression_plan(grads),
                                   strict=True):
            if axes is not None:
                gf = errors[path].add_(g)  # g + e in fp32, held in e until the residual
                scale = all_max(gf.abs().amax(-1, keepdim=True), axes).div_(127.0).clamp_min_(
                    1e-12)
                deq = torch.round(gf / scale).clamp_(-127, 127).to(torch.int8).float().mul_(scale)
                g.copy_(deq)
                gf.sub_(deq)
        return grads, error

    def wire_bytes(self, grads, plan=None):
        """(uncompressed, compressed) bytes of the gradients on the wire: int8
        and a float32 scale a row for each leaf the plan compresses."""
        raw = sum(g.numel() * 4 for _, g in tree_items(grads))
        return raw, raw - sum(g.numel() * 3 - g.numel() // g.shape[-1] * 4 for (_, g), axes in zip(
            tree_items(grads), plan or compression_plan(grads), strict=True) if axes is not None)
