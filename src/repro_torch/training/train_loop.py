"""The train step: loss, gradients by autograd, then (optionally) the int8
round trip of gradient compression, then the optimizer (a port of
``repro.training.train_loop``).

Under a mesh (``distributed.use_mesh``, with the rules the parameters were
sharded by active: ``ZERO1_PARAM_RULES`` or ``DEFAULT_RULES``) the step is
one rank's, as the reference's GSPMD step under ``dryrun_lib.lower_cell``'s
shardings: the parameters are its shards (``shard_params``), the optimizer
state its shards under ``DEFAULT_RULES`` (``opt_state_axes``: FSDP on
"embed"), the batch its data shard's rows.  The loss is its rows' token
losses over the global count (``Model._shard_ce``), so the gradients sum to
the reference's mean; each gradient is reduced over the batch axes onto the
optimizer's shard (``collectives.reduce_grad``; under FSDP the weight's
gather already reduce-scattered it over "data"), the optimizer updates the
shard, and under ZeRO-1 the updated shards are all-gathered back into the
replicated weights.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import fsdp_gather, reduce_grad
from repro_torch.distributed.sharding import (DEFAULT_RULES, axes_leaves, current_mesh,
                                              mesh_sizes, param_axes, param_specs, tree_specs)
from repro_torch.models.moe import BATCH_AXES
from repro_torch.params import tree_items, tree_map
from repro_torch.training.optimizer import (AdafloorState, AdamWState, OptConfig, Shard,
                                            _factored, apply_updates, make_optimizer)


def opt_state_axes(opt_name, params_axes, params_shapes):
    """Logical axes of the optimizer state, leaf for leaf (the reference's;
    its ``_like_factored`` is ``optimizer._factored``)."""
    if opt_name == "adamw":
        return AdamWState(step=(), mu=params_axes, nu=params_axes)
    if opt_name != "adafloor":
        raise ValueError(opt_name)

    def over(fn):  # fn(axes, factored) for each leaf
        return tree_map(lambda ax, shp: fn(tuple(ax), _factored(shp)), params_axes, params_shapes,
                        is_leaf=lambda x: isinstance(x, tuple) and all(
                            a is None or isinstance(a, str) for a in x))

    return AdafloorState(step=(), vr=over(lambda ax, f: ax[:-1] if f else ax),
                         vc=over(lambda ax, f: ax[:-2] + ax[-1:] if f else (None,)))


def mesh_layout(cfg, params):
    """Each leaf's layout under the active mesh and rules, in the
    ``tree_items`` order of ``params``, decided once from its spec as ``shard_params`` resolves it
    (``param_specs``) and its optimizer state's under DEFAULT_RULES: (its
    optimizer shard (``Shard``: its whole shape and each dimension's mesh
    axes), the dimension of its ZeRO-1 piece over "data" or None, the
    dimensions FSDP gathers over "data")."""
    from repro_torch.models.model import Model

    sizes = mesh_sizes(current_mesh())
    whole = Model(cfg, "meta").init(0)
    axes, out = param_axes(whole), {}
    for (path, w), *specs in zip(tree_items(whole), *(axes_leaves(t) for t in (
            param_specs(axes, whole, sizes, cfg=cfg), tree_specs(axes, whole, sizes, DEFAULT_RULES))),
                              strict=True):
        own, opt = ([() if e is None else (e,) if isinstance(e, str) else e
                     for e in (*spec, *(None,) * w.ndim)][:w.ndim] for spec in specs)
        dims = tuple(tuple(a for a in dict.fromkeys(o + p) if sizes[a] > 1) for o, p in zip(own, opt))
        fsdp = tuple(d for d in range(w.ndim) if "data" in dims[d] and "data" in own[d])
        zero1 = next((d for d in range(w.ndim) if "data" in dims[d] and d not in fsdp), None)
        out[path] = Shard(tuple(w.shape), dims), zero1, fsdp
    return list(zip(*(out[path] for path, _ in tree_items(params)), strict=True))


def make_train_step(model, opt_cfg=None, compression=None):
    """Returns (init_opt_state, train_step); ``train_step(params, opt_state,
    batch)`` -> (params, opt_state, metrics).  With ``compression`` (a
    ``GradientCompressor``) the optimizer state is ``(state, error)`` and the
    gradients take the int8 round trip, with error feedback, before the
    optimizer.  ``train_step.grads(params, batch)`` -> (loss, metrics,
    gradients on the optimizer's shards) and ``train_step.update(params,
    opt_state, grads, metrics)`` are its two halves."""
    opt_init, opt_update = make_optimizer(model.cfg.optimizer, opt_cfg or OptConfig(),
                                          model.cfg.scan_block)
    kept = []

    def layout(params):
        """Under a mesh, ``mesh_layout`` of the parameters (kept)."""
        if current_mesh() is None:
            return None
        if compression is not None:
            raise ValueError("gradient compression under a mesh is not ported")
        if not kept:
            kept.append(mesh_layout(model.cfg, params))
        return kept[0]

    def pieces(params, lay):
        """The optimizer's pieces of the parameters: ZeRO-1's whole weights
        narrowed to the rank's data shard (views)."""
        if lay is None:
            return params
        n = mesh_sizes(current_mesh()).get("data", 1)
        j = dist.get_rank(current_mesh().get_group("data")) if n > 1 else 0
        it = iter(p if d is None else p.narrow(d, j * p.shape[d] // n, p.shape[d] // n)
                  for (_, p), d in zip(tree_items(params), lay[1], strict=True))
        return tree_map(lambda _: next(it), params)

    def init_opt_state(params):
        lay = layout(params)
        state = opt_init(pieces(params, lay), lay and lay[0])
        return state if compression is None else (state, compression.init_error(params))

    def grads_of(params, batch):
        lay = layout(params)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = [p for _, p in tree_items(live)]
        for p, dims in zip(leaves, lay[2] if lay else (), strict=bool(lay)):
            p.fsdp_dims = dims  # gathered where it is used (``layers.gather_weights``)
        loss, metrics = model.loss_fn(live, batch)
        grads = list(torch.autograd.grad(loss, leaves))
        del live, leaves
        if lay is not None:  # onto the optimizer's shard over the batch axes (FSDP's
            # gather reduce-scattered it over "data" already)
            grads = [reduce_grad(g, d, ("pod",) if f else BATCH_AXES)
                     for g, d, f in zip(grads, *lay[1:], strict=True)]
        grads = iter(grads)
        return loss, metrics, tree_map(lambda _: next(grads), params)

    def update(params, opt_state, grads, metrics):
        lay = layout(params)
        if compression is not None:
            opt_state, err = opt_state
            grads, err = compression.compress_decompress(grads, err)
        mine = pieces(params, lay)
        updates, opt_state, opt_metrics = opt_update(grads, opt_state, mine, lay and lay[0])
        if compression is not None:
            opt_state = (opt_state, err)
        metrics = {k: v.detach() for k, v in {**metrics, **opt_metrics}.items()}
        apply_updates(mine, updates)
        for (_, p), (_, piece), d in zip(tree_items(params), tree_items(mine),
                                         lay[1] if lay else (), strict=False):
            if d is not None:  # ZeRO-1: the shards back into the whole weight
                p.copy_(fsdp_gather(piece, d))
        return params, opt_state, metrics

    def train_step(params, opt_state, batch):
        _, metrics, grads = grads_of(params, batch)
        return update(params, opt_state, grads, metrics)

    train_step.grads, train_step.update = grads_of, update
    return init_opt_state, train_step
