"""The train step: loss, gradients by autograd, then the optimizer (a port of
``repro.training.train_loop``)."""
from __future__ import annotations

import torch

from repro_torch.params import tree_items, tree_map
from repro_torch.training.optimizer import OptConfig, apply_updates, make_optimizer


def make_train_step(model, opt_cfg=None, compression=None):
    """Returns (init_opt_state, train_step); ``train_step(params, opt_state,
    batch)`` -> (params, opt_state, metrics).  Gradient compression (the
    reference's int8 wire format) is M11 and not ported."""
    if compression is not None:
        raise NotImplementedError("gradient compression is M11 and not ported yet")
    opt_init, opt_update = make_optimizer(model.cfg.optimizer, opt_cfg or OptConfig(),
                                          model.cfg.scan_block)

    def train_step(params, opt_state, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = [p for _, p in tree_items(live)]
        loss, metrics = model.loss_fn(live, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
        del live, leaves
        updates, opt_state, opt_metrics = opt_update(tree_map(lambda _: next(grads), params),
                                                     opt_state, params)
        metrics = {k: v.detach() for k, v in {**metrics, **opt_metrics}.items()}
        return apply_updates(params, updates), opt_state, metrics

    return opt_init, train_step
