"""AdamW with a warmup-cosine schedule and global-norm clipping (a port of
``repro.training.optimizer``).

``make_optimizer(name, cfg)`` returns ``(init, update)`` with the reference's
contract: ``state = init(params)``; ``updates, state, metrics = update(grads,
state, params)``; ``params = apply_updates(params, updates)``.  The moments
are float32 whatever the parameters' dtype; each update is cast to its
parameter's dtype.  The scalars (step, learning rate, norm) are float32 as in
JAX.  Unlike JAX, ``update`` steps the moments in place, with the same
arithmetic: the state it returns holds the same tensors, so the old and new
moments (8 bytes a parameter each) are never alive together.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.params import tree_items, tree_map


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
    clip_norm: float = 1.0


def lr_schedule(cfg, step):
    """Linear warmup, then cosine decay to ``min_lr_frac`` (float32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (0.5 * (1 + torch.cos(math.pi * prog)))
    return cfg.learning_rate * warm * frac


def global_norm(tree):
    return torch.sqrt(sum(x.float().square().sum() for _, x in tree_items(tree)))


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
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(torch.zeros((), dtype=torch.int32), tree_map(zeros, params),
                          tree_map(zeros, params))

    def update(grads, state, params):
        step = state.step + 1
        norm = global_norm(grads)
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


def make_optimizer(name, cfg=None):
    if name == "adamw":
        return adamw(cfg or OptConfig())
    if name == "adafloor":
        raise NotImplementedError("adafloor (jamba-398b's optimizer) is not ported yet "
                                  "(ROADMAP §1 item 3, with jamba)")
    raise ValueError(f"unknown optimizer {name!r}")


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
