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
replicated weights.  Gradient compression runs on those reduced shards, with
its error tree on the same pieces.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.collectives import fsdp_gather, reduce_grad
from repro_torch.distributed.compression import compression_plan
from repro_torch.distributed.sharding import (DEFAULT_RULES, axes_leaves, current_mesh,
                                              mesh_coord, mesh_sizes, param_axes, param_specs,
                                              piece_bounds, tree_specs)
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
    dimensions FSDP gathers over "data", where the rank's shard starts in
    the whole leaf (``piece_bounds``), where its optimizer piece starts)."""
    from repro_torch.models.model import Model

    mesh = current_mesh()
    sizes, j = mesh_sizes(mesh), mesh_coord(mesh).get("data", 0)
    whole = Model(cfg, "meta").init(0)
    axes, out = param_axes(whole), {}
    for (path, w), *specs, (starts, shape) in zip(
            tree_items(whole), *(axes_leaves(t) for t in (
                param_specs(axes, whole, sizes, cfg=cfg),
                tree_specs(axes, whole, sizes, DEFAULT_RULES))),
            piece_bounds(whole, axes, mesh, cfg=cfg), strict=True):
        own, opt = ([() if e is None else (e,) if isinstance(e, str) else e
                     for e in (*spec, *(None,) * w.ndim)][:w.ndim] for spec in specs)
        dims = tuple(tuple(a for a in dict.fromkeys(o + p) if sizes[a] > 1) for o, p in zip(own, opt))
        fsdp = tuple(d for d in range(w.ndim) if "data" in dims[d] and "data" in own[d])
        zero1 = next((d for d in range(w.ndim) if "data" in dims[d] and d not in fsdp), None)
        mine = tuple(a + (j * n // sizes["data"] if d == zero1 else 0)
                     for d, (a, n) in enumerate(zip(starts, shape, strict=True)))
        out[path] = Shard(tuple(w.shape), dims), zero1, fsdp, starts, mine
    return list(zip(*(out[path] for path, _ in tree_items(params)), strict=True))


def make_train_step(model, opt_cfg=None, compression=None):
    """Returns (init_opt_state, train_step); ``train_step(params, opt_state,
    batch)`` -> (params, opt_state, metrics).  With ``compression`` (a
    ``GradientCompressor``) the optimizer state is ``(state, error)`` and the
    gradients take the int8 round trip, with error feedback, before the
    optimizer; under a mesh on the optimizer's pieces, after the reduction
    over the batch axes, where the reference's global gradients are (the
    error tree lies on those pieces too).  ``train_step.grads(params,
    batch)`` -> (loss, metrics, gradients on the optimizer's shards) and
    ``train_step.update(params, opt_state, grads, metrics)`` are its two
    halves; ``train_step.places(params)``: under a mesh, where this rank's
    leaves of the parameters and of the optimizer state start in the whole
    ones ({"params": [...], "opt": [...]}, in ``tree_items`` order, for
    ``CheckpointManager``), None without one."""
    opt_init, opt_update = make_optimizer(model.cfg.optimizer, opt_cfg or OptConfig(),
                                          model.cfg.scan_block)
    kept = {}

    def layout(params):
        """Under a mesh, ``mesh_layout`` of the parameters; both it and the
        compressor's ``compression_plan`` decided once (kept)."""
        if not kept:
            kept["layout"] = current_mesh() and mesh_layout(model.cfg, params)
            kept["plan"] = compression_plan(params, model.cfg.scan_block,
                                            kept["layout"] and kept["layout"][0])
        return kept["layout"] if current_mesh() else None

    def pieces(params, lay):
        """The optimizer's pieces of the parameters: ZeRO-1's whole weights
        narrowed to the rank's data shard (views)."""
        if lay is None:
            return params
        n = mesh_sizes(current_mesh()).get("data", 1)
        it = iter(p if d is None else p.narrow(d, mine[d] - own[d], p.shape[d] // n)
                  for (_, p), d, own, mine in zip(tree_items(params), lay[1], lay[3], lay[4],
                                                  strict=True))
        return tree_map(lambda _: next(it), params)

    def init_opt_state(params):
        lay = layout(params)
        mine = pieces(params, lay)
        state = opt_init(mine, lay and lay[0])
        return state if compression is None else (state, compression.init_error(mine))

    def places(params):
        lay = layout(params)
        if lay is None:
            return None
        shards, _, _, own, mine = lay
        if model.cfg.optimizer == "adafloor":  # a factored leaf's rows and columns apart
            f = [_factored(s.shape) for s in shards]
            state = [(), *(m[:-1] if x else m for m, x in zip(mine, f, strict=True)),
                     *(m[:-2] + m[-1:] if x else (0,) for m, x in zip(mine, f, strict=True))]
        else:
            state = [(), *mine, *mine]
        return {"params": list(own), "opt": state + (list(mine) if compression else [])}

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
                     for g, d, f in zip(grads, lay[1], lay[2], strict=True)]
        grads = iter(grads)
        return loss, metrics, tree_map(lambda _: next(grads), params)

    def update(params, opt_state, grads, metrics):
        lay = layout(params)
        if compression is not None:
            opt_state, err = opt_state
            grads, err = compression.compress_decompress(grads, err, kept["plan"])
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

    train_step.grads, train_step.update, train_step.places = grads_of, update, places
    return init_opt_state, train_step
