"""Public model API: ``build_model(cfg, device)`` -> :class:`Model`
(a port of the serving half of ``repro.models.model``).

Parameters are a dict: ``{"embedding": {"table"[, "head"]}, "layers": [per-
layer dict, ...], "final_norm"}``.  A dense decode cache is ``{"k", "v": (L,
B, cap, K, D), "kv_pos": (L, B, cap) int32, "len": (B,) int32}``; a paged one
is ``{"k", "v": (L, n_pages + 1, ps, K, D), "len", "bt": (B, P) int32}`` (see
``models.attention``).  Both are preallocated once and updated in place
where the JAX package donated them.
"""
from __future__ import annotations


import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_tokens, init_embedding, rms_norm, unembed


class Model:
    def __init__(self, cfg, device):
        tfm.check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)

    def init(self, seed):
        """Random weights from a seeded generator on the model's device, with
        the distributions of ``repro``'s init (the numbers differ)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {
            "embedding": init_embedding(gen, cfg, dt, dev),
            "layers": [tfm.init_layer(gen, cfg, dt, dev) for _ in range(cfg.n_layers)],
            "final_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
        }

    def init_cache(self, batch, max_len):
        cfg = self.cfg
        cap = attn.cache_capacity(cfg, max_len)
        shape = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.head_dim)
        dev = self.device
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=dev),
            "v": torch.zeros(shape, dtype=self.dtype, device=dev),
            "kv_pos": torch.full(shape[:3], -1, dtype=torch.int32, device=dev),
            "len": torch.zeros(batch, dtype=torch.int32, device=dev),
        }

    def init_paged_cache(self, batch, n_pages, page_size, max_context):
        """Paged decode cache: zeroed per-layer page pools (plus the spare
        page) and block tables of -1 sized for ``max_context`` tokens."""
        cfg, dev = self.cfg, self.device
        shape = (cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=dev),
            "v": torch.zeros(shape, dtype=self.dtype, device=dev),
            "len": torch.zeros(batch, dtype=torch.int32, device=dev),
            "bt": torch.full((batch, -(-max_context // page_size)), -1, dtype=torch.int32,
                             device=dev),
        }

    def _logits(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed(params["embedding"], x, cfg.tie_embeddings, cfg.vocab_size).float()

    def prefill(self, params, batch, max_len):
        """Run the prompt; returns (last-token logits (B, V) fp32, cache).

        ``batch["tokens"]`` (B, S); optional ``batch["lengths"]`` (B,) gives
        each row's real length in a right-padded bucket (default S).  The
        cache is seeded by the gather of ``prefill_fill_cache``, so padding
        stays invisible to decode.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
        cap = attn.cache_capacity(cfg, max_len)
        L, K, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        cache = {
            "k": torch.empty((L, B, cap, K, D), dtype=self.dtype, device=self.device),
            "v": torch.empty((L, B, cap, K, D), dtype=self.dtype, device=self.device),
            "kv_pos": torch.empty((L, B, cap), dtype=torch.int32, device=self.device),
            "len": lengths.to(torch.int32),
        }
        x = embed_tokens(params["embedding"], tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        for i, layer in enumerate(params["layers"]):
            x, (k, v) = tfm.block_prefill(layer, cfg, x, positions)
            cache["k"][i], cache["v"][i], cache["kv_pos"][i] = attn.prefill_fill_cache(
                k, v, lengths, cap, self.dtype)
        idx = (lengths.long() - 1).clamp(0, S - 1)
        last = x[torch.arange(B, device=x.device), idx][:, None]
        return self._logits(params, last)[:, 0], cache

    def decode_step(self, params, cache, tokens, last=None):
        """tokens (B, T), T = 1 (plain) or depth+1 (verify).  Returns logits
        (B, T, V) fp32, or (B, 1, V) at the positions ``last`` (B,) when given;
        the cache is written in place and ``len`` grows by T."""
        x = embed_tokens(params["embedding"], tokens)
        for i, layer in enumerate(params["layers"]):
            view = {name: cache[name][i] for name in ("k", "v", "kv_pos") if name in cache}
            x = tfm.block_decode(layer, self.cfg, x, view, cache["len"], cache.get("bt"))
        cache["len"] += tokens.shape[1]
        if last is not None:
            x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return self._logits(params, x)

    def chunk_prefill(self, params, cache, tokens, lens, n_new, last=None):
        """Ingest ``n_new[b]`` of row b's tokens at cursor ``lens[b]``: one
        decode step, then a rewind to ``lens + n_new`` (the padding written
        past it stays shadowed by the positional mask).  Paged admission is
        this step over the whole decode batch; rows with ``n_new = 0`` idle."""
        cache["len"].copy_(lens)
        logits = self.decode_step(params, cache, tokens, last)
        self.commit_cache(cache, lens, n_new - 1)
        return logits

    @staticmethod
    def commit_cache(cache, old_len, accept_idx):
        """Roll back to old_len + accept_idx + 1 committed tokens, in place.
        Attention caches rewind by pointer: stale slots stay masked."""
        cache["len"].copy_(old_len + accept_idx + 1)


def build_model(cfg, device="cpu"):
    return Model(cfg, device)
