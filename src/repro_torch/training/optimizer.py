"""AdamW and adafloor with a warmup-cosine schedule and global-norm clipping
(a port of ``repro.training.optimizer``).

``make_optimizer(name, cfg, scan_block)`` returns ``(init, update)`` with the
reference's contract: ``state = init(params)``; ``updates, state, metrics =
update(grads, state, params)``; ``params = apply_updates(params, updates)``.
The optimizer state is float32 whatever the parameters' dtype; each update is
cast to its parameter's dtype.  The scalars (step, learning rate, norm) are
float32 as in JAX.  Unlike JAX, the port works in place with the same
arithmetic: ``update`` steps the state's tensors and returns them, and
``apply_updates`` adds into the parameters, so a step makes no second copy
of the parameters or the state; adafloor also writes each update into its
gradient's tensor (jamba's 11.9B parameters at two full-width layers hold
23.8 GB of bf16 parameters and as much of gradients).

Under a mesh each leaf is the rank's shard and ``layout`` gives, leaf for
leaf, its whole shape and the mesh axes each dimension is split over
(``Shard``): the global norm counts each distinct shard once, adafloor
decides factoring on the whole shape and all-reduces its row and column
means and its RMS clip over the dimensions a shard splits.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, NamedTuple

import torch

from repro_torch.distributed.collectives import all_sum
from repro_torch.distributed.sharding import current_mesh, mesh_sizes
from repro_torch.params import tree_items, tree_map


class Shard(NamedTuple):
    shape: tuple  # the whole leaf's
    dims: tuple   # each dimension's mesh axes (``()``: whole)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_rms: float = 1.0  # adafloor's update clipping
    clip_norm: float = 1.0


def lr_schedule(cfg, step):
    """Linear warmup, then cosine decay to ``min_lr_frac`` (float32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (0.5 * (1 + torch.cos(math.pi * prog)))
    return cfg.learning_rate * warm * frac


def _whole(tree, layout):
    """``layout``, or without a mesh each leaf whole on no mesh axis."""
    return layout or [Shard(x.shape, ((),) * x.ndim) for _, x in tree_items(tree)]


def global_norm(tree, layout=None):
    """The norm over every leaf; under a mesh each leaf's squares over the
    ranks that hold it alike divided out, then summed over the mesh."""
    sizes = mesh_sizes(current_mesh() or {})
    sq = sum(x.float().square().sum() / math.prod(n for a, n in sizes.items()
                                                  if all(a not in d for d in s.dims))
             for (_, x), s in zip(tree_items(tree), _whole(tree, layout), strict=True))
    return torch.sqrt(all_sum(sq, tuple(sizes)))


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to at most ``max_norm`` in float32, the norm before)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


class AdamWState(NamedTuple):
    step: Any   # int32 scalar tensor
    mu: Any
    nu: Any


def adamw(cfg):
    def init(params, layout=None):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(torch.zeros((), dtype=torch.int32), tree_map(zeros, params),
                          tree_map(zeros, params))

    def update(grads, state, params, layout=None):
        step = state.step + 1
        norm = global_norm(grads, layout)
        scale = _clip_scale(norm, cfg.clip_norm)  # clip_by_global_norm, leaf by leaf
        lr = lr_schedule(cfg, step)
        b1, b2 = cfg.beta1, cfg.beta2
        c1, c2 = (1 - torch.tensor(b, dtype=torch.float32) ** step.float() for b in (b1, b2))

        def leaf(p, g, m, v):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) + cfg.weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        updates = tree_map(leaf, params, grads, state.mu, state.nu)
        return updates, AdamWState(step, state.mu, state.nu), {"grad_norm": norm, "lr": lr}

    return init, update


class AdafloorState(NamedTuple):
    step: Any   # int32 scalar tensor
    vr: Any     # a factored leaf's row statistics, else its whole second moment
    vc: Any     # a factored leaf's column statistics, else a (1,) placeholder


def _factored(p):
    """The reference's test, on a shape or a leaf.  It sees a layer's leaf
    stacked over the blocks, which changes nothing while a stack has fewer
    than 128 blocks."""
    shape = getattr(p, "shape", p)
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def _mean(x, dim, axes, n):
    """x's mean along ``dim`` of ``n`` whole entries, its shard's sum
    all-reduced over ``axes`` where that dimension is split."""
    return x.mean(dim) if not axes else all_sum(x.sum(dim), axes) / n


def _stacks(params, scan_block):
    """Leaf indices (in ``tree_items`` order) grouped as the reference
    stacks its leaves: a layer's leaf with the same leaf of every layer
    ``scan_block`` apart (the blocks), any other leaf alone."""
    stacks = {}
    for i, (path, _) in enumerate(tree_items(params)):
        top, *rest = path.split("/")
        if top in ("layers", "encoder"):
            rest[0] = int(rest[0]) % scan_block
        stacks.setdefault((top, *rest), []).append(i)
    return stacks.values()


PIECE = 1 << 28  # elements of a leaf that adafloor takes at once (1 GiB in float32)


def _slices(p, g, vr, vc, whole):
    """(parameter, gradient, vr, vc or None if the ``whole`` leaf is not
    factored) cut along the first axis into slices of at most PIECE
    elements, a leaf of fewer than 3 axes whole: a slice's statistics depend
    on it alone."""
    vc = vc if _factored(whole) else None
    if p.ndim < 3:
        return [(p, g, vr, vc)]
    n = max(1, PIECE * p.shape[0] // p.numel())
    return zip(p.split(n), g.split(n), vr.split(n),
               itertools.repeat(None) if vc is None else vc.split(n), strict=False)


def adafloor(cfg, scan_block=1):
    """Adafactor-style: a factored second moment and no momentum, the update
    clipped to RMS ``clip_rms`` over the reference's stacked leaf: a layer's
    leaf together with the same leaf of every layer ``scan_block`` apart.
    Two passes over each stack, slice by slice (``_slices``): the statistics
    and the sum of u², then the clipped update."""
    def init(params, layout=None):
        shapes = [s.shape for s in _whole(params, layout)]

        def zeros(factored, whole):  # each leaf's state, factored by its whole shape
            it = iter(shapes)
            return tree_map(lambda p: torch.zeros(factored(p) if _factored(next(it)) else whole(p),
                                                  dtype=torch.float32, device=p.device), params)

        return AdafloorState(torch.zeros((), dtype=torch.int32),
                             zeros(lambda p: p.shape[:-1], lambda p: p.shape),
                             zeros(lambda p: p.shape[:-2] + p.shape[-1:], lambda p: (1,)))

    def update(grads, state, params, layout=None):
        step = state.step + 1
        norm = global_norm(grads, layout)
        scale = _clip_scale(norm, cfg.clip_norm)  # clip_by_global_norm, leaf by leaf
        lr = lr_schedule(cfg, step)
        decay = 1.0 - (step.float() + 1.0) ** -0.8

        def direction(g, vr, vc, first, shard):
            """u of a slice; ``first`` steps its statistics in place first."""
            g = g.float() * scale
            (rows, cols), (m, n) = ((), ()), (0, 0)
            if vc is not None:  # factored: its rows and columns may be split
                (rows, cols), (m, n) = shard.dims[-2:], shard.shape[-2:]
            if first:
                g2 = g.square().add_(1e-30)
                vr.mul_(decay).add_((1 - decay) * (g2 if vc is None else _mean(g2, -1, cols, n)))
                if vc is not None:
                    vc.mul_(decay).add_((1 - decay) * _mean(g2, -2, rows, m))
            if vc is None:
                return g.mul_(torch.rsqrt(vr + 1e-30))
            denom = (vr[..., None] * vc[..., None, :]).div_(
                _mean(vr, -1, rows, m).clamp(min=1e-30)[..., None, None])
            return g.mul_(denom.add_(1e-30).rsqrt_())

        leaves = [[x for _, x in tree_items(t)] for t in (params, grads, state.vr, state.vc)]
        layout = _whole(params, layout)
        for stack in _stacks(params, scan_block):
            shard = layout[stack[0]]
            parts = [s for i in stack for s in _slices(*(t[i] for t in leaves), shard.shape)]
            sq = sum(direction(*s[1:], True, shard).square().sum() for s in parts)
            n = len(stack) * math.prod(shard.shape)
            sq = all_sum(sq, sorted({a for d in shard.dims for a in d}))
            div = torch.clamp(torch.sqrt(sq / n + 1e-30) / cfg.clip_rms, min=1.0)
            for p, g, vr, vc in parts:
                u = direction(g, vr, vc, False, shard).div_(div).add_(cfg.weight_decay * p.float())
                g.copy_(u.mul_(-lr))
        return grads, AdafloorState(step, state.vr, state.vc), {"grad_norm": norm, "lr": lr}

    return init, update


def make_optimizer(name, cfg=None, scan_block=1):
    """``scan_block``: the model's, which decides adafloor's stacks."""
    if name == "adamw":
        return adamw(cfg or OptConfig())
    if name == "adafloor":
        return adafloor(cfg or OptConfig(), scan_block)
    raise ValueError(f"unknown optimizer {name!r}")


def apply_updates(params, updates):
    """``params`` with each update added in place (the same bits as ``p + u``)."""
    for (_, p), (_, u) in zip(tree_items(params), tree_items(updates), strict=True):
        p.add_(u.to(p.dtype))
    return params
