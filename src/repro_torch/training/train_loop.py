"""The train step: loss, gradients by autograd, then (optionally) the int8
round trip of gradient compression, then the optimizer (a port of
``repro.training.train_loop``)."""
from __future__ import annotations

import torch

from repro_torch.params import tree_items, tree_map
from repro_torch.training.optimizer import OptConfig, apply_updates, make_optimizer


def make_train_step(model, opt_cfg=None, compression=None):
    """Returns (init_opt_state, train_step); ``train_step(params, opt_state,
    batch)`` -> (params, opt_state, metrics).  With ``compression`` (a
    ``GradientCompressor``) the optimizer state is ``(state, error)`` and the
    gradients take the int8 round trip, with error feedback, before the
    optimizer."""
    opt_init, opt_update = make_optimizer(model.cfg.optimizer, opt_cfg or OptConfig(),
                                          model.cfg.scan_block)

    def init_opt_state(params):
        state = opt_init(params)
        return state if compression is None else (state, compression.init_error(params))

    def train_step(params, opt_state, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = [p for _, p in tree_items(live)]
        loss, metrics = model.loss_fn(live, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
        del live, leaves
        grads = tree_map(lambda _: next(grads), params)
        if compression is not None:
            opt_state, err = opt_state
            grads, err = compression.compress_decompress(grads, err)
        updates, opt_state, opt_metrics = opt_update(grads, opt_state, params)
        if compression is not None:
            opt_state = (opt_state, err)
        metrics = {k: v.detach() for k, v in {**metrics, **opt_metrics}.items()}
        return apply_updates(params, updates), opt_state, metrics

    return init_opt_state, train_step
