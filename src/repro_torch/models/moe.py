"""Mixture-of-experts with sort-based dispatch (a port of
``repro.models.moe``; training adds the router's two auxiliary losses).

Each token picks its ``top_k`` experts from an fp32 router.  The
assignments are sorted by expert id (stably, so each expert's tokens keep
their order), ranked within their expert, and written into a fixed-capacity
buffer of ``C`` slots an expert; an assignment ranked past ``C`` is dropped.
The expert FFNs run as one batched product over all E experts, and each
token sums its kept results over its k choices.  This is the reference's
single-capacity-space formulation (``apply_moe_global``), which is what its
``apply_moe`` computes without a mesh.  Under a mesh (``distributed.use_mesh``)
the reference's two other layouts run: hierarchical (per data shard
capacity) and expert parallel over the "model" axis.

Capacity couples the rows of a call: ``C`` comes from every token of the
call (idle decode rows, bucket padding and verify padding included), and
whether a token keeps its expert depends on the tokens ranked before it.

The capacity comes from shapes alone and every op keeps a fixed shape, so a
MoE layer captures in a CUDA graph.  Each (expert, slot) of the buffer has
one writer, and the combine is a gather and a sum over k in a fixed order
(the reference's scatter-add, which ``index_add_`` would make atomic and
unordered on the card), so a graphed step equals an eager one bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed.collectives import all_sum, model_copy
from repro_torch.distributed.sharding import current_mesh, data_shards, mesh_sizes
from repro_torch.models.layers import dense_init


def _expert_stack(gen, E, in_dim, out_dim, dtype, device):
    """(E, in_dim, out_dim) truncated normal with fan-in scale, one fp32
    stack at a time (805 MB for qwen3-moe's (128, 2048, 768))."""
    w = torch.empty((E, in_dim, out_dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def init_moe(gen, cfg, dtype, device):
    """The router (d, E) in float32 in every model dtype, and the expert
    stacks ``wi``, ``wg`` (swiglu) (E, d, f) and ``wo`` (E, f, d)."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {"router": dense_init(gen, d, E, torch.float32, device),
         "wi": _expert_stack(gen, E, d, f, dtype, device)}
    if cfg.mlp_type == "swiglu":
        p["wg"] = _expert_stack(gen, E, d, f, dtype, device)
    p["wo"] = _expert_stack(gen, E, f, d, dtype, device)
    return p


BATCH_AXES = ("pod", "data")


def capacity(n_tokens, cfg, capacity_factor):
    """Slots an expert: ceil(T k cf / E), rounded up to a multiple of 8 and
    bounded by T k."""
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k * capacity_factor / m.n_experts))
    return min(max(8, -(-c // 8) * 8), n_tokens * m.top_k)


def route(p, cfg, tokens, losses=False):
    """Top-k routing in fp32 on the upcast tokens (..., d): renormalised
    weights and expert ids (..., k); with ``losses`` (training) also the
    router's auxiliary losses: ``load_balance`` = E sum_e density_e / k
    mean_prob_e (the density, from the top-k ids, takes no gradient) and
    ``router_z`` = mean(logsumexp(logits)^2).  Under a mesh the tokens are
    this rank's data shard's, and the density, the mean probability and
    router_z's mean are taken over every shard's (the reference keeps its
    router global), all-reduced over the batch axes."""
    logits = tokens.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = probs.topk(cfg.moe.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    if not losses:
        return top_w, top_e
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    density = F.one_hot(top_e, E).sum(-2).reshape(-1, E).float().mean(0)
    mean_prob = probs.reshape(-1, E).mean(0)
    density, mean_prob, z = (all_sum(t, BATCH_AXES) / data_shards() for t in (
        density, mean_prob, torch.logsumexp(logits, -1).square().mean()))
    return top_w, top_e, {"load_balance": E * (density / K * mean_prob).sum(), "router_z": z}


def sort_rank(flat_e, C):
    """Sort the assignments by expert (stable), rank each within its expert
    and mask those past capacity: (order, sorted experts, rank with dropped
    assignments at C, keep)."""
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    rank = torch.arange(len(se), device=se.device) - torch.searchsorted(se, se, side="left")
    keep = rank < C
    return order, se, torch.where(keep, rank, C), keep


def _distinct_slots(se, rank_c, keep, E, C):
    """Training's dispatch and combine rows, in sorted order and no two
    alike: a kept assignment its (expert, rank) slot, a dropped one a slot
    that no kept assignment fills (a capacity factor of at least 1 leaves
    E C >= T k slots).  A repeated index makes CUDA's index backward, and
    index_put under deterministic algorithms, walk its duplicates one after
    another, and serving's layout puts every dropped assignment on one row
    (PERF.md §6, PR 26)."""
    experts = torch.arange(E, device=se.device)
    filled = torch.searchsorted(se, experts, side="right") - torch.searchsorted(se, experts)
    used = torch.arange(C, device=se.device) < filled.clamp(max=C)[:, None]
    free = torch.argsort(used.flatten().int(), stable=True)  # the unfilled slots first
    return torch.where(keep, se * C + rank_c, free[(torch.cumsum(~keep, 0) - 1).clamp_min(0)])


def expert_ffn(p, cfg, buf):
    """The batched expert FFNs over the (E, C, d) buffer, all E experts."""
    h = torch.bmm(buf, p["wi"])
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.bmm(buf, p["wg"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["wo"])


def _moe(p, cfg, x, capacity_factor, losses=False, shards=1, lo=0, n_loc=None):
    """Route x (B, S, d), dispatch, the expert FFNs, combine.  The T tokens
    form ``shards`` groups of consecutive tokens, each with capacity(T /
    shards) slots an expert (an assignment's group e * shards + s is sorted
    and ranked on its own: the reference's hierarchical layout), and the
    buffer holds only the experts [lo, lo + n_loc) (expert parallel: this
    rank's), whose weights ``p`` holds; other assignments weigh 0."""
    B, S, d = x.shape
    T, E, K = B * S, cfg.moe.n_experts, cfg.moe.top_k
    G, first = (n_loc or E) * shards, lo * shards  # the (expert, shard) groups computed here
    C = capacity(T // shards, cfg, capacity_factor)
    tokens = x.reshape(T, d)
    top_w, top_e, *aux = route(p, cfg, tokens, losses)
    flat_e = top_e.reshape(-1)
    if shards > 1:  # assignment i is token i // K's, in shard i // (K T / shards)
        flat_e = flat_e * shards + torch.arange(T * K, device=x.device) // (T // shards * K)
    order, se, rank_c, keep = sort_rank(flat_e, C)
    mine = keep if n_loc is None else keep & (se >= first) & (se < first + G)
    # dispatch: serving sends a dropped assignment (or another rank's) to the
    # spare row G * C, past the buffer, never onto a kept token's slot;
    # training without a mesh to a slot of its own that no kept assignment
    # fills (its result weighs 0).  Expert parallel training keeps the spare
    # row: its buffer has no room for the other ranks' assignments.
    distinct = losses and n_loc is None
    if distinct:
        dest = _distinct_slots(se, rank_c, keep, E, C)
    else:
        dest = torch.where(mine, (se - first) * C + rank_c, G * C)
        tokens, top_w = model_copy(tokens), model_copy(top_w)  # the rank's experts' shares
    buf = x.new_zeros((G * C + (not distinct), d))
    buf[dest] = tokens[order // K]
    out_buf = expert_ffn(p, cfg, buf[:G * C].view(G // shards, shards * C, d)).view(G * C, d)
    # combine: each assignment's slot back in token order, its result
    # gathered (the others weigh 0) and summed over the token's k choices
    slot, used = torch.empty_like(dest), torch.empty_like(mine)
    slot[order], used[order] = dest, mine
    if not distinct:
        slot = torch.where(used, slot, 0)
    w = (top_w.reshape(-1) * used).to(x.dtype)
    out = (out_buf[slot] * w[:, None]).view(T, K, d).sum(1).reshape(B, S, d)
    return (out, *aux) if losses else out


def apply_moe_hierarchical(p, cfg, x, capacity_factor=1.25):
    """The reference's shard-local dispatch batched on one device: x's tokens
    form data_shards() groups of consecutive tokens (one when they do not
    divide), each with its own capacity; every expert's buffer holds the
    groups' slots side by side."""
    DS = data_shards()
    return _moe(p, cfg, x, capacity_factor, shards=DS if x.shape[0] * x.shape[1] % DS == 0 else 1)


def apply_moe_expert_parallel(p, cfg, x, capacity_factor=1.25, losses=False):
    """Expert parallelism over the active mesh's "model" axis (the
    reference's ``apply_moe_shardmap``), run on every rank: x is this rank's
    data shard's tokens, routed in fp32 and ranked with capacity(T_local);
    the rank computes its E / n_model experts (``p``'s stacks hold those), or
    where E < n_model its f / n_model columns of every expert, then one
    all-reduce over "model" sums the ranks' results.  With ``losses``
    (training) returns (out, the router's losses), the gradient of the
    whole tokens and weights summed over "model" (``model_copy``)."""
    n = mesh_sizes(current_mesh())["model"]
    E, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
    if E % n and (n % E or f % n):
        raise ValueError(f"expert parallel: {E} experts of {f} columns do not split over "
                         f"a {n}-way model axis")
    group = current_mesh().get_group("model")
    n_loc = E if E < n else E // n
    out = _moe(p, cfg, x, capacity_factor, losses, lo=0 if E < n else dist.get_rank(group) * n_loc,
               n_loc=n_loc)
    if losses:
        return all_sum(out[0], ("model",)), out[1]
    dist.all_reduce(out, group=group)
    return out


def apply_moe(p, cfg, x, capacity_factor=1.25, losses=False):
    """x (B, S, d) -> (B, S, d); with ``losses`` (training) returns (out, the
    router's losses).  The gradient reaches the router through the kept
    assignments' weights and the experts through dispatch and combine; a
    dropped assignment gets none.  Under a mesh, as the reference's default
    dispatch: expert parallel when it has a "model" axis, else
    hierarchical, where x is this rank's data shard, one shard of that
    layout (``apply_moe_hierarchical`` holds them all on one device); the
    capacity is the rank's tokens', the router's losses global (``route``)."""
    mesh = current_mesh()
    if mesh is not None and "model" in mesh_sizes(mesh):
        return apply_moe_expert_parallel(p, cfg, x, capacity_factor, losses)
    return _moe(p, cfg, x, capacity_factor, losses)
