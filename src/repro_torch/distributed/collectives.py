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
  partial results and the gather of head- or vocab-sharded outputs.

Each function runs on every rank of the mesh (:func:`use_mesh`), as the
reference's run inside ``shard_map``.
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


def model_sum(x, sharded):
    """Sum a row-parallel product's partial results over "model", in place,
    where its weight is a shard (``model_split``); x as it is otherwise."""
    if sharded:
        dist.all_reduce(x, group=_group("model"))
    return x


def model_gather(x, dim):
    """All-gather over "model": the ranks' pieces of x, joined along ``dim``
    in rank order."""
    n = model_rank()[0]
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))  # gloo takes the pieces along dim 0
    dist.all_gather_into_tensor(out, x.contiguous(), group=_group("model"))
    return torch.cat(out.view(n, *x.shape).unbind(0), dim)


def hierarchical_all_reduce(x, pod_axis, inner_axis):
    """reduce_scatter(inner) -> all_reduce(pod) -> all_gather(inner): the sum
    over both axes, with only 1/inner of the bytes crossing the pod axis."""
    inner = _group(inner_axis)
    n = dist.get_world_size(inner)
    xp = torch.cat([x, x.new_zeros(((-x.shape[0]) % n, *x.shape[1:]))]).contiguous()
    piece = xp.new_empty((xp.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(piece, xp, group=inner)
    dist.all_reduce(piece, group=_group(pod_axis))
    dist.all_gather_into_tensor(xp, piece, group=inner)
    return xp[:x.shape[0]]


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
