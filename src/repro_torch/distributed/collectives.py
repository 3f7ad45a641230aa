"""Collectives over the named dimensions of the active mesh (a port of
``repro.distributed.collectives``): the reference's shard_map building
blocks as real ``torch.distributed`` collectives on each dimension's process
group, never emulated.

* hierarchical all-reduce: reduce-scatter inside the pod, all-reduce on the
  pod axis over 1/N of the bytes, all-gather inside the pod;
* ring all-gather: n - 1 send/receive steps to the next rank;
* the log-sum-exp merge of partial attention over a sequence-sharded KV
  cache, and context-parallel decode attention on top of it;
* tensor parallelism on "model": the sum of a row-parallel product's
  partial results and the gather of head- or vocab-sharded outputs;
* training under a mesh: the same collectives with their gradients, FSDP's
  gather of a weight's "embed" shards over "data", and the gradient
  reduction over the batch axes.

Each function runs on every rank of the mesh (:func:`use_mesh`), as the
reference's run inside ``shard_map``.

Gradients follow Megatron's f/g pair.  A tensor every rank of an axis holds
alike takes its whole gradient on each of them; a rank's share of a sum
(a row-parallel product, a rank-specific use of a whole tensor) takes its
part.  :func:`model_sum` (all-reduce forward, identity backward) joins the
parts into a whole tensor; :func:`model_copy` (identity forward, all-reduce
backward) marks a whole tensor's entry into a rank-specific computation, so
that the parts of its gradient are summed; :func:`model_gather` takes the
rank's slice of a whole gradient.  Under ``no_grad`` (serving) each issues
exactly the calls it issued before it had a gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import current_mesh, mesh_sizes, use_mesh


def _group(axis):
    return current_mesh().get_group(axis)


def model_rank():
    """(n, j): the active mesh's "model" axis size and this rank's index on
    it; (1, 0) without one."""
    mesh = current_mesh()
    if mesh is None or mesh_sizes(mesh).get("model", 1) == 1:
        return 1, 0
    group = _group("model")
    return dist.get_world_size(group), dist.get_rank(group)


def model_split(local, whole):
    """(n, j, sharded): ``model_rank``, and whether a weight dimension of
    ``local`` entries is this rank's shard of one of ``whole`` (the layer
    then runs tensor parallel) rather than whole.  Every layer decides its
    layout here."""
    n, j = model_rank()
    return n, j, n > 1 and local < whole


def _records(x):
    return torch.is_grad_enabled() and x.requires_grad


def _spanned(axes):
    """The mesh axes of ``axes`` that are larger than 1."""
    return [a for a in axes if mesh_sizes(current_mesh() or {}).get(a, 1) > 1]


def _all_reduce(x, axes):
    for axis in _spanned(axes):
        dist.all_reduce(x, group=_group(axis))
    return x


def _gather(x, dim, group):
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))  # gloo takes the pieces along dim 0
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return torch.cat(out.view(n, *x.shape).unbind(0), dim)


def _scatter(g, dim, group):
    """reduce-scatter: the sum over ``group`` of g, this rank's piece along ``dim``."""
    parts = g.chunk(dist.get_world_size(group), dim)
    piece = torch.empty_like(parts[0], memory_format=torch.contiguous_format)
    dist.reduce_scatter_tensor(piece, torch.cat(parts).contiguous(), group=group)
    return piece


def _summed(x, axes):
    return _all_reduce(x.clone(memory_format=torch.contiguous_format), axes)


class _Sum(torch.autograd.Function):
    """All-reduce over ``axes`` forward (into a copy: "minimal" remat may keep
    x, a product's output) and the whole gradient backward, or (``copy``)
    the identity forward and the gradient's parts summed backward."""

    @staticmethod
    def forward(ctx, x, axes, copy=False):
        ctx.axes, ctx.copy = axes, copy
        return x.view_as(x) if copy else _summed(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.axes) if ctx.copy else g, None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axis`` forward; backward the rank's
    slice of the whole gradient, or (``reduce``) the reduce-scatter of the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, axis, reduce):
        ctx.args = dim, axis, x.shape[dim], reduce
        return _gather(x, dim, _group(axis))

    @staticmethod
    def backward(ctx, g):
        dim, axis, size, reduce = ctx.args
        group = _group(axis)
        return (_scatter(g, dim, group) if reduce else
                g.narrow(dim, dist.get_rank(group) * size, size).contiguous()), None, None, None


def all_sum(x, axes):
    """The sum of x over the mesh axes ``axes`` (those larger than 1), in
    place without a gradient; under autograd each rank's x takes the whole
    gradient (its share of a sum every rank holds)."""
    return _Sum.apply(x, axes) if _records(x) and _spanned(axes) else _all_reduce(x, axes)


def model_sum(x, sharded):
    """Sum a row-parallel product's partial results over "model", in place,
    where its weight is a shard (``model_split``); x as it is otherwise."""
    return all_sum(x, ("model",)) if sharded else x


def all_max(x, axes):
    """The elementwise max of x over the mesh axes ``axes`` (those larger
    than 1), in place, no gradient: exact in any order."""
    for axis in _spanned(axes):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=_group(axis))
    return x


def model_copy(x, sharded=True):
    """x, entering a rank-specific computation on "model" (a column-parallel
    product, a shard's use of a whole tensor): its gradient's parts summed
    over "model".  x itself without a gradient or unsharded."""
    return _Sum.apply(x, ("model",), True) if sharded and model_rank()[0] > 1 and _records(
        x) else x


def model_gather(x, dim):
    """All-gather over "model": the ranks' pieces of x, joined along ``dim``
    in rank order; the gradient the rank's slice."""
    return _Gather.apply(x, dim, "model", False) if _records(x) else _gather(x, dim,
                                                                           _group("model"))


def fsdp_gather(w, dim):
    """FSDP's all-gather of a weight's shards along ``dim`` over "data"; its
    gradient reduce-scattered back onto the shard."""
    return _Gather.apply(w, dim, "data", True) if _records(w) else _gather(w, dim, _group("data"))


def reduce_grad(g, dim, axes):
    """A gradient's sum over the batch axes ``axes`` (of those the mesh
    has), onto the optimizer's shard: reduce-scatter along ``dim`` over
    "data" (the whole sum where ``dim`` is None), then all-reduce over
    "pod" (the reference's hierarchical split)."""
    if dim is not None and "data" in _spanned(axes):
        g = _scatter(g, dim, _group("data"))
        axes = [a for a in axes if a != "data"]
    return _all_reduce(g.contiguous(), axes)


def hierarchical_all_reduce(x, pod_axis, inner_axis):
    """reduce_scatter(inner) -> all_reduce(pod) -> all_gather(inner): the sum
    over both axes, with only 1/inner of the bytes crossing the pod axis."""
    inner = _group(inner_axis)
    n = dist.get_world_size(inner)
    piece = _scatter(torch.cat([x, x.new_zeros(((-x.shape[0]) % n, *x.shape[1:]))]), 0, inner)
    dist.all_reduce(piece, group=_group(pod_axis))
    return _gather(piece, 0, inner)[:x.shape[0]]


def ring_all_gather(x, axis):
    """All-gather as a ring: each step sends the last piece received to the
    next rank.  The pieces come in ring order, shard (idx - j) mod n at j, and
    are rolled by idx shards along dim 0 exactly as the reference rolls them,
    which leaves shard (2 idx - q) mod n at place q: index order only for
    n <= 2."""
    group = _group(axis)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    peer = [dist.get_global_rank(group, (idx + s) % n) for s in (1, -1)]
    pieces = [x.contiguous()]
    for _ in range(n - 1):
        pieces.append(torch.empty_like(x))
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, pieces[-2], peer[0], group),
                                            dist.P2POp(dist.irecv, pieces[-1], peer[1], group)]):
            work.wait()
    return torch.roll(torch.cat(pieces), idx * x.shape[0], 0)


def lse_merge(num, m, lsum, axis):
    """Merge partial attention over a sequence-sharded KV: ``num`` (..., D)
    = sum_j exp(s_j - m) v_j, ``m`` (...) the local max logit, ``lsum`` (...)
    the local sum of exp(s_j - m).  One MAX all-reduce for the global max,
    then one SUM all-reduce of the rescaled numerator and denominator."""
    group = _group(axis)
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_glob)[..., None]
    both = torch.cat([num * corr, lsum[..., None] * corr], -1)
    dist.all_reduce(both, group=group)
    return both[..., :-1] / both[..., -1:].clamp_min(1e-30)


def context_parallel_decode_attention(q, k_shard, v_shard, kv_pos_shard, cache_len, axis,
                                      scale=None, window=None):
    """Decode attention against a KV cache sharded along the sequence over
    ``axis``: q (B, T, H, D), whole on every rank of the axis; k/v_shard (B,
    S/n, K, D) and kv_pos_shard (B, S/n) (-1 empty) this rank's slots;
    cache_len (B,) the length with the T new tokens.  Each rank computes
    fp32 flash-decode stats over its slots (causal on positions, under an
    optional sliding ``window``); :func:`lse_merge` combines them."""
    B, T, H, D = q.shape
    K = k_shard.shape[2]
    qf = q.reshape(B, T, K, H // K, D).float() * (scale if scale is not None else D ** -0.5)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k_shard.float())
    q_pos = cache_len[:, None] - T + torch.arange(T, device=q.device)
    kp = kv_pos_shard[:, None, :]
    mask = (kp >= 0) & (kp <= q_pos[:, :, None])  # (B, T, S/n)
    if window is not None:
        mask &= kp > q_pos[:, :, None] - window
    s = s.masked_fill(~mask[:, None, None], -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    num = torch.einsum("bkgts,bskd->bkgtd", p, v_shard.float())
    out = lse_merge(num, m, p.sum(-1), axis)  # (B, K, G, T, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)


def make_hierarchical_psum(mesh):
    """The hierarchical gradient reduction over a (pod, data) mesh, as a
    function of this rank's shard."""
    def reduce_fn(x):
        with use_mesh(mesh):
            return hierarchical_all_reduce(x, "pod", "data")

    return reduce_fn
