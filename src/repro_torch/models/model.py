"""Public model API: ``build_model(cfg, device)`` -> :class:`Model`
(a port of the serving half of ``repro.models.model``).

Parameters are a dict: ``{"embedding": {"table"[, "head"]}, "layers": [per-
layer dict, ...], "final_norm"}``.  The decode cache holds ``len`` (B,)
int32 and the stacked tensors of the layer kinds present, each stacked over
the layers of its kind:

* attention, dense: ``k``, ``v`` (L, B, cap, K, D) and ``kv_pos`` (L, B,
  cap) int32; paged: ``k``, ``v`` (L, n_pages + 1, ps, K, D) and ``bt`` (B,
  P) int32 (see ``models.attention``);
* Mamba2: ``conv`` (L, B, d_conv-1, C_ch) in the model dtype and ``state``
  (L, B, H, P, N) fp32, plus the per-token ``conv_all`` and ``states_all``
  (L, B, T, ...) that speculative rollback selects from (``models.ssm``).

Every cache is preallocated once and updated in place where the JAX package
donated it.  At mamba2-2.7b's full width with 8 slots a pair holds 1.34 GB
(1.25 GiB) of fp32 ``state`` and 12.1 GB (11.3 GiB) of ``states_all`` for a
9-token verify; two pairs beside the 5.4 GB of shared bf16 weights fit the
80 GB of one H100 (sizes from the shapes, not measured).
"""
from __future__ import annotations


import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_tokens, init_embedding, rms_norm, unembed

_ATTN_KEYS = ("k", "v", "kv_pos")


class Model:
    def __init__(self, cfg, device):
        tfm.check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)
        kinds = cfg.layer_kinds()
        self.kinds = kinds
        # each layer's index in the stacked cache tensors of its kind
        self._slot = [kinds[:i].count(kind) for i, kind in enumerate(kinds)]
        self.n_attn, self.n_ssm = kinds.count("attn"), kinds.count("ssm")

    def init(self, seed):
        """Random weights from a seeded generator on the model's device, with
        the distributions of ``repro``'s init (the numbers differ)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        cfg, dt, dev = self.cfg, self.dtype, self.device
        return {
            "embedding": init_embedding(gen, cfg, dt, dev),
            "layers": [tfm.init_layer(gen, cfg, kind, dt, dev) for kind in self.kinds],
            "final_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
        }

    def _attn_cache(self, batch, cap, fill):
        cfg, dev = self.cfg, self.device
        shape = (self.n_attn, batch, cap, cfg.n_kv_heads, cfg.head_dim)
        make = torch.zeros if fill else torch.empty
        return {"k": make(shape, dtype=self.dtype, device=dev),
                "v": make(shape, dtype=self.dtype, device=dev),
                "kv_pos": (torch.full(shape[:3], -1, dtype=torch.int32, device=dev) if fill
                           else torch.empty(shape[:3], dtype=torch.int32, device=dev))}

    def init_cache(self, batch, max_len, steps=0):
        """Zeroed decode cache; ``steps`` preallocates the SSM layers'
        per-token states for verify steps of up to that many tokens."""
        cache = {"len": torch.zeros(batch, dtype=torch.int32, device=self.device)}
        if self.n_attn:
            cache.update(self._attn_cache(batch, attn.cache_capacity(self.cfg, max_len), True))
        if self.n_ssm:
            cache.update(ssm.init_mamba_cache(self.cfg, self.n_ssm, batch, self.dtype,
                                              self.device, steps))
        return cache

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
        attention cache is seeded by the gather of ``prefill_fill_cache``, so
        padding stays invisible to decode.  A stack with SSM layers takes
        unpadded rows only: the SSM state would absorb the padding.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
        elif self.n_ssm and set(lengths.tolist()) != {S}:
            raise ValueError("prefill of a stack with SSM layers needs every row "
                             "unpadded (lengths == S): the SSM state would absorb padding")
        cap = attn.cache_capacity(cfg, max_len)
        # a copy: decode grows the cache's len in place, never the caller's lengths
        cache = {"len": lengths.to(torch.int32, copy=True)}
        if self.n_attn:
            cache.update(self._attn_cache(B, cap, False))
        if self.n_ssm:
            cache.update(ssm.init_mamba_cache(cfg, self.n_ssm, B, self.dtype, self.device))
        x = embed_tokens(params["embedding"], tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        for layer, j in zip(params["layers"], self._slot, strict=True):
            x, new = tfm.block_prefill(layer, cfg, x, positions)
            if "attn" in layer:
                cache["k"][j], cache["v"][j], cache["kv_pos"][j] = attn.prefill_fill_cache(
                    *new, lengths, cap, self.dtype)
            else:
                cache["conv"][j], cache["state"][j] = new
        idx = (lengths.long() - 1).clamp(0, S - 1)
        last = x[torch.arange(B, device=x.device), idx][:, None]
        return self._logits(params, last)[:, 0], cache

    def decode_step(self, params, cache, tokens, last=None):
        """tokens (B, T), T = 1 (plain) or depth+1 (verify).  Returns logits
        (B, T, V) fp32, or (B, 1, V) at the positions ``last`` (B,) when given;
        the cache is written in place and ``len`` grows by T.  SSM layers
        keep their state after each of the T tokens (allocated here if the
        cache has fewer than T positions for them)."""
        T = tokens.shape[1]
        if self.n_ssm and ("states_all" not in cache or cache["states_all"].shape[2] < T):
            B = tokens.shape[0]
            cache.update({k: v for k, v in ssm.init_mamba_cache(
                self.cfg, self.n_ssm, B, self.dtype, self.device, T).items()
                if k in ssm.STEP_KEYS})
        x = embed_tokens(params["embedding"], tokens)
        for layer, j in zip(params["layers"], self._slot, strict=True):
            names = _ATTN_KEYS if "attn" in layer else ssm.CACHE_KEYS + ssm.STEP_KEYS
            view = {name: cache[name][j] for name in names if name in cache}
            x = tfm.block_decode(layer, self.cfg, x, view, cache["len"], cache.get("bt"))
        cache["len"] += T
        if last is not None:
            x = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return self._logits(params, x)

    def chunk_prefill(self, params, cache, tokens, lens, n_new, last=None):
        """Ingest ``n_new[b]`` of row b's tokens at cursor ``lens[b]``: one
        decode step, then a rewind to ``lens + n_new`` (the padding written
        past it stays shadowed by the positional mask).  Paged admission is
        this step over the whole decode batch; rows with ``n_new = 0`` idle.
        Attention-only stacks (the engine gates on the architecture)."""
        cache["len"].copy_(lens)
        logits = self.decode_step(params, cache, tokens, last)
        self.commit_cache(cache, lens, n_new - 1)
        return logits

    @staticmethod
    def commit_cache(cache, old_len, accept_idx):
        """Roll back to old_len + accept_idx + 1 committed tokens, in place.
        Attention caches rewind by pointer (stale slots stay masked); SSM
        layers take the state and conv window at ``accept_idx`` per row."""
        if "states_all" in cache:
            rows = torch.arange(accept_idx.shape[0], device=accept_idx.device)
            idx = accept_idx.long()
            cache["state"].copy_(cache["states_all"][:, rows, idx])
            cache["conv"].copy_(cache["conv_all"][:, rows, idx])
        cache["len"].copy_(old_len + accept_idx + 1)


def build_model(cfg, device="cpu"):
    return Model(cfg, device)
