"""Layer walkers for attention+MLP, attention+MoE and Mamba2 stacks, for
the hybrid interleave of Mamba2 and attention layers with MoE on some, and
for an encoder-decoder's two stacks (a port of ``repro.models.transformer``).

The JAX package stacks layer parameters and scans over them; here the stack
is a Python list of per-layer parameter dicts and a loop.  Training
(``scan_full``) runs every layer kind under the reference's three remat
policies and carries the MoE router's two losses, summed over the MoE
layers from zero; under FSDP each layer gathers its weights inside its
remat, so "minimal" and "full" gather them again in the backward.  A layer holds
``attn`` or ``mamba`` (per ``cfg.layer_kinds()``), in a decoder layer of an
encoder-decoder also ``cross`` (cross attention over the encoder's memory
``mem`` = (K, V[, mem_len, mem_pos]), after the self attention), and a MoE
layer (per ``cfg.moe_layer_mask()``) or, when ``d_ff > 0``, an MLP.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import apply_mlp, gather_weights, init_mlp, rms_norm


def init_layer(gen, cfg, kind, is_moe, dtype, device, cross=False):
    ones = torch.ones(cfg.d_model, dtype=dtype, device=device)
    layer = {"norm1": ones}
    if kind == "attn":
        layer["attn"] = attn.init_attention(gen, cfg, dtype, device)
    else:
        layer["mamba"] = ssm.init_mamba(gen, cfg, dtype, device)
    if cross:  # a decoder layer of an encoder-decoder
        layer["norm_cross"] = ones.clone()
        layer["cross"] = attn.init_attention(gen, cfg, dtype, device, cross=True)
    if is_moe:
        layer["norm2"] = ones.clone()
        layer["moe"] = moe_mod.init_moe(gen, cfg, dtype, device)
    elif cfg.d_ff > 0:
        layer["norm2"] = ones.clone()
        layer["mlp"] = init_mlp(gen, cfg, cfg.d_ff, dtype, device)
    return layer


def _apply_cross(layer, cfg, x, mem):
    if "cross" not in layer:
        return x
    h = rms_norm(x, layer["norm_cross"], cfg.norm_eps)
    return x + attn.attention_cross(layer["cross"], cfg, h, *mem)


def _apply_ffn(layer, cfg, x, aux=None):
    """The layer's MoE or MLP half.  With ``aux`` (training) returns (x, aux
    plus a MoE layer's router losses); serving computes no losses."""
    if "moe" in layer:
        h = rms_norm(x, layer["norm2"], cfg.norm_eps)
        if aux is None:
            return x + moe_mod.apply_moe(layer["moe"], cfg, h)
        out, losses = moe_mod.apply_moe(layer["moe"], cfg, h, losses=True)
        return x + out, {k: v + losses[k] for k, v in aux.items()}
    if "mlp" in layer:
        x = x + apply_mlp(layer["mlp"], cfg, rms_norm(x, layer["norm2"], cfg.norm_eps))
    return x if aux is None else (x, aux)


def block_prefill(layer, cfg, x, positions, mem=None):
    """One layer of prefill: returns (x, what seeds its cache): (k, v) for
    attention, (conv, state) for a Mamba2 layer."""
    h = rms_norm(x, layer["norm1"], cfg.norm_eps)
    if "attn" in layer:
        out, new = attn.attention_prefill(layer["attn"], cfg, h, positions)
    else:
        out, new = ssm.mamba_prefill(layer["mamba"], cfg, h)
    return _apply_ffn(layer, cfg, _apply_cross(layer, cfg, x + out, mem)), new


def block_decode(layer, cfg, x, cache,
                 cache_len, block_tables=None, mem=None):
    """One layer of a T-token decode step; its cache views update in place."""
    h = rms_norm(x, layer["norm1"], cfg.norm_eps)
    if "attn" in layer:
        out = attn.attention_decode(layer["attn"], cfg, h, cache, cache_len, block_tables)
    else:
        out = ssm.mamba_decode(layer["mamba"], cfg, h, cache)
    return _apply_ffn(layer, cfg, _apply_cross(layer, cfg, x + out, mem))


def block_full(layer, cfg, x, positions, aux, causal=True, cross_mem=None):
    """One layer of the training forward, or of an encoder (not ``causal``):
    attention or Mamba2, then the MoE or MLP half; returns (x, aux plus a MoE
    layer's router losses).  ``cross_mem``, the whole encoder output (B, M,
    d): the layer projects it through its own cross K/V weights."""
    layer = gather_weights(layer)  # FSDP: whole for this layer only
    h = rms_norm(x, layer["norm1"], cfg.norm_eps)
    if "attn" in layer:
        x = x + attn.attention_full(layer["attn"], cfg, h, positions, causal)
    else:
        x = x + ssm.mamba_full(layer["mamba"], cfg, h)
    if cross_mem is not None:
        x = _apply_cross(layer, cfg, x, attn.cross_memory(layer["cross"], cfg, cross_mem))
    return _apply_ffn(layer, cfg, x, aux)


# matrix products without batch dimensions (the projections and the MLP):
# what the reference's dots_with_no_batch_dims_saveable keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy):
    """``fn`` under a remat policy: "none" saves every activation, "full"
    only the layer's input (the layer runs again in the backward), "minimal"
    also the products of ``_DOTS``.  Remat changes no number."""
    if policy == "none":
        return fn
    kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts, _save_dots)
          } if policy == "minimal" else {}
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
                             **kw)


def scan_full(layers, cfg, x, positions, remat="none", causal=True, cross_mem=None):
    """The training (or encoder) forward's layer loop, each layer under
    ``remat``: (x, the router's losses summed over the MoE layers, fp32
    scalars from zero)."""
    step = _remat(block_full, remat)
    aux = {k: torch.zeros((), device=x.device) for k in ("load_balance", "router_z")}
    for layer in layers:
        x, aux = step(layer, cfg, x, positions, aux, causal, cross_mem)
    return x, aux
