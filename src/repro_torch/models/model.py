"""Public model API: ``build_model(cfg, device="cuda")`` -> :class:`Model`
(a port of ``repro.models.model``: serving, and training's ``forward`` and
``loss_fn``, with a MoE model's router losses).

Parameters are a dict: ``{"embedding": {"table"[, "head"]}, "layers": [per-
layer dict, ...], "final_norm"}``, and for an encoder-decoder also
``"encoder"`` (its own layer list) and ``"enc_norm"``.  Batches are
``{"tokens": (B, S)}``, plus ``"patches"`` (B, n_patches, d_model) for a
vision frontend (prepended to the text; logits cover the text only) or
``"frames"`` (B, M, d_model) for an encoder-decoder (the encoder's input).
The decode cache holds ``len`` (B,) int32 and the stacked tensors of the
layer kinds present, each stacked over the layers of its kind:

* attention, dense: ``k``, ``v`` (L, B, cap, K, D) and ``kv_pos`` (L, B,
  cap) int32; paged: ``k``, ``v`` (L, n_pages + 1, ps, K, D) and ``bt`` (B,
  P) int32 (see ``models.attention``);
* Mamba2: ``conv`` (L, B, d_conv-1, C_ch) in the model dtype and ``state``
  (L, B, H, P, N) fp32, plus the per-token ``conv_all`` and ``states_all``
  (L, B, T, ...) that speculative rollback selects from (``models.ssm``);
* an encoder-decoder's cross memory, written once at prefill: ``cross_k``,
  ``cross_v`` (L, B, M, K, D), ``mem_len`` (B,) int32 and ``mem_pos`` (B, M)
  int32, the positions cross attention reads (-1 past ``mem_len``).

Every cache is preallocated once and updated in place where the JAX package
donated it.  At mamba2-2.7b's full width with 8 slots a pair holds 1.34 GB
(1.25 GiB) of fp32 ``state`` and 12.1 GB (11.3 GiB) of ``states_all`` for a
9-token verify; two pairs beside the 5.4 GB of shared bf16 weights fit the
80 GB of one H100.  qwen3-moe-30b-a3b's bf16 weights are 61.06 GB, made on
the device one tensor at a time (an expert stack's fp32 temporary is at
most 805 MB), and its 512-slot caches 0.81 GB for 16 slots; mixtral-8x7b at
16 of its 32 layers holds 46.96 GB (its fp32 temporary 1.88 GB) and 4.33 GB
of 4128-slot rings for 16 slots (sizes from the shapes, not measured).
"""
from __future__ import annotations


import torch

from repro_torch.distributed.collectives import (all_max, all_sum, model_gather, model_split,
                                                 model_sum)
from repro_torch.distributed.sharding import (CACHE_AXES, DEFAULT_RULES, current_mesh,
                                              data_shards, local_shape, logical_to_spec,
                                              mesh_sizes)
from repro_torch.kernels.decode_attention import dense_positions
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed_tokens, gather_weights, init_embedding, rms_norm,
                                      unembed)
from repro_torch.models.moe import BATCH_AXES

_TOP = ("embedding", "final_norm", "enc_norm")  # the leaves outside the layers
_ATTN_KEYS = ("k", "v", "kv_pos")
_CROSS_KEYS = ("cross_k", "cross_v")


class Model:
    def __init__(self, cfg, device):
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
        gen = (None if self.device.type == "meta"  # shapes only: no numbers to draw
               else torch.Generator(device=self.device).manual_seed(seed))
        cfg, dt, dev = self.cfg, self.dtype, self.device
        params = {
            "embedding": init_embedding(gen, cfg, dt, dev),
            "layers": [tfm.init_layer(gen, cfg, kind, is_moe, dt, dev, cfg.is_encdec)
                       for kind, is_moe in zip(self.kinds, cfg.moe_layer_mask(), strict=True)],
            "final_norm": torch.ones(cfg.d_model, dtype=dt, device=dev),
        }
        if cfg.is_encdec:
            params["encoder"] = [tfm.init_layer(gen, cfg, "attn", False, dt, dev)
                                 for _ in range(cfg.n_encoder_layers)]
            params["enc_norm"] = torch.ones(cfg.d_model, dtype=dt, device=dev)
        return params

    def _layout(self, batch, cap, steps=0, cross_len=None):
        """{key: (whole shape, dtype, fill value)} of the decode cache."""
        cfg, dt, i32 = self.cfg, self.dtype, torch.int32
        out = {"len": ((batch,), i32, 0)}
        if self.n_attn:
            kv = (self.n_attn, batch, cap, cfg.n_kv_heads, cfg.head_dim)
            out.update(k=(kv, dt, 0), v=(kv, dt, 0), kv_pos=(kv[:3], i32, -1))
        if cfg.is_encdec:
            mem = (cfg.n_layers, batch, cross_len or 1, cfg.n_kv_heads, cfg.head_dim)
            out.update(cross_k=(mem, dt, 0), cross_v=(mem, dt, 0), mem_len=((batch,), i32, 0),
                       mem_pos=(mem[1:3], i32, -1))
        if self.n_ssm:
            out.update(ssm.mamba_cache_layout(cfg, self.n_ssm, batch, dt, steps))
        return out

    def _make(self, layout, fill=True, rows=True):
        """The cache tensors of a layout.  Under a mesh each is this rank's
        shard by ``sharding.CACHE_AXES`` (``rows`` False: the batch given is
        already the rank's rows): its data shard's rows where the batch
        splits, its slots of a context-parallel attention cache, its KV or
        SSM heads and conv channels where those split."""
        mesh, out = current_mesh(), {}
        for key, (shape, dtype, value) in layout.items():
            if mesh is not None:
                axes = tuple(a if rows or a != "batch" else None for a in CACHE_AXES[key])
                whole, sizes = shape, mesh_sizes(mesh)
                shape = local_shape(shape, logical_to_spec(axes, mesh, DEFAULT_RULES, shape), sizes)
                if key == "k" and shape[2] == whole[2] and sizes.get("model", 1) > 1:
                    raise ValueError(f"context-parallel decode: cache capacity {whole[2]} does "
                                     f"not split into {sizes['model']}")
            out[key] = (torch.full(shape, value, dtype=dtype, device=self.device) if fill
                        else torch.empty(shape, dtype=dtype, device=self.device))
        return out

    def init_cache(self, batch, max_len, steps=0, cross_len=None):
        """Zeroed decode cache; ``steps`` preallocates the SSM layers'
        per-token states for verify steps of up to that many tokens; an
        encoder-decoder's holds ``cross_len`` (default 1) memory slots, all
        invalid.  Under a mesh it is this rank's shard (``_make``)."""
        return self._make(self._layout(batch, attn.cache_capacity(self.cfg, max_len), steps,
                                       cross_len))

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

    def _embed_inputs(self, params, batch):
        """(x, n_prefix): the tokens' embeddings, behind a vision frontend's
        ``patches`` (n_prefix of them)."""
        x = embed_tokens(params["embedding"], batch["tokens"], self.cfg.padded_vocab)
        front = self.cfg.frontend
        if front is None or front.kind != "vision":
            return x, 0
        return torch.cat([batch["patches"].to(x.dtype), x], 1), batch["patches"].shape[1]

    def _encode(self, params, frames, remat="none"):
        """The encoder over ``frames`` (B, M, d): no causal mask, RoPE at
        positions 0 .. M - 1; then ``enc_norm``."""
        cfg = self.cfg
        x = frames.to(self.dtype)
        B, M = x.shape[:2]
        positions = torch.arange(M, device=x.device)[None].expand(B, M)
        x = tfm.scan_full(params["encoder"], cfg, x, positions, remat, causal=False)[0]
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    @staticmethod
    def _memory(enc_out):
        """(mem_len (B,) int32, mem_pos (B, M) int32) of a whole encoder output."""
        B, M = enc_out.shape[:2]
        mem_len = torch.full((B,), M, dtype=torch.int32, device=enc_out.device)
        return mem_len, dense_positions(mem_len, M)

    def _forward(self, params, batch, gather=True):
        """(logits (B, S, V) fp32, the router's losses summed over the layers);
        not ``gather``: a vocab shard's logits stay this rank's."""
        cfg = self.cfg
        params = {**params, **gather_weights({k: params[k] for k in _TOP if k in params})}
        # the memory is whole: cross attention takes no mem_len (K2, unmasked)
        cross_mem = (self._encode(params, batch["frames"], cfg.remat_policy) if cfg.is_encdec
                     else None)
        x, n_prefix = self._embed_inputs(params, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, aux = tfm.scan_full(params["layers"], cfg, x, positions, cfg.remat_policy,
                               cross_mem=cross_mem)
        if gather:
            return self._logits(params, x[:, n_prefix:]), aux
        x = rms_norm(x[:, n_prefix:], params["final_norm"], cfg.norm_eps)
        return (unembed(params["embedding"], x, cfg.tie_embeddings, cfg.vocab_size, False).float(),
                aux)

    def forward(self, params, batch):
        """Full-sequence logits (B, S, V) fp32 of ``batch["tokens"]`` (B, S)
        (training; layers under ``cfg.remat_policy``)."""
        return self._forward(params, batch)[0]

    def loss_fn(self, params, batch):
        """Next-token cross-entropy, ``logsumexp - target logit`` averaged over
        (B, S - 1), plus for a MoE model its router losses weighted by
        ``cfg.moe``; returns (loss, metrics ``ce``, ``ppl_log``, ``loss`` and
        for MoE ``load_balance`` and ``router_z``).  Under a mesh a rank's
        loss takes its rows' share of the mean (``_shard_ce``) and the global
        router losses, and its metrics are global (``ce`` summed over the
        batch axes)."""
        mesh = current_mesh() is not None
        logits, aux = self._forward(params, batch, gather=not mesh)
        logits, targets = logits[:, :-1], batch["tokens"][:, 1:].long()
        if mesh:
            ce = self._shard_ce(logits, targets)
        else:
            tgt = logits.gather(-1, targets[..., None])[..., 0]
            ce = (torch.logsumexp(logits, -1) - tgt).mean()
        m = self.cfg.moe

        def total(ce):
            return ce if m is None else (ce + m.load_balance_loss * aux["load_balance"]
                                         + m.router_z_loss * aux["router_z"])

        loss = total(ce)
        shown = all_sum(ce.detach().clone(), BATCH_AXES) if mesh else ce
        metrics = {"ce": shown, "ppl_log": shown, **(aux if m is not None else {})}
        metrics["loss"] = total(shown) if mesh else loss
        return loss, metrics

    def _shard_ce(self, logits, targets):
        """The sum of this rank's token losses over the global token count
        (the ranks' gradients sum to those of the reference's mean); vocab
        parallel where the logits are a vocab shard: a MAX all-reduce, then
        the sum of exp and the target logit, masked to its rank, summed over
        "model"."""
        V = logits.shape[-1]
        _, j, sharded = model_split(V, self.cfg.padded_vocab)
        m = all_max(logits.detach().amax(-1), ("model",) if sharded else ())
        lse = torch.log(model_sum(torch.exp(logits - m[..., None]).sum(-1), sharded)) + m
        idx = targets - j * V
        held = (idx >= 0) & (idx < V)  # the target's column on this rank
        tgt = model_sum(logits.gather(-1, idx.clamp(0, V - 1)[..., None])[..., 0] * held, sharded)
        return (lse - tgt).sum() / (targets.numel() * data_shards())

    def prefill(self, params, batch, max_len):
        """Run the prompt; returns (last-token logits (B, V) fp32, cache).

        ``batch["tokens"]`` (B, S); optional ``batch["lengths"]`` (B,) gives
        each row's real length in a right-padded bucket (default S).  The
        attention cache is seeded by the gather of ``prefill_fill_cache``, so
        padding stays invisible to decode.  A stack with SSM layers takes
        unpadded rows only: the SSM state would absorb the padding.  A
        frontend's patches count in S (decode goes on after them); an
        encoder-decoder runs its encoder over ``batch["frames"]`` and stores
        each decoder layer's cross K/V of it.  Neither takes ``lengths``, as
        in the reference.
        """
        cfg = self.cfg
        lengths = batch.get("lengths")
        if lengths is not None and (cfg.is_encdec or cfg.frontend is not None):
            raise NotImplementedError("bucketed prefill: enc-dec and frontend-prefix "
                                      "models take unpadded rows")
        x, _ = self._embed_inputs(params, batch)
        B, S = x.shape[:2]
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
        elif self.n_ssm and set(lengths.tolist()) != {S}:
            raise ValueError("prefill of a stack with SSM layers needs every row "
                             "unpadded (lengths == S): the SSM state would absorb padding")
        cap = attn.cache_capacity(cfg, max_len)
        enc_out = self._encode(params, batch["frames"]) if cfg.is_encdec else None
        layout = self._layout(B, cap, cross_len=enc_out.shape[1] if cfg.is_encdec else None)
        # a copy: decode grows the cache's len in place, never the caller's lengths
        cache = {"len": lengths.to(torch.int32, copy=True)}
        cache.update(self._make({k: v for k, v in layout.items()
                                 if k not in ("len", "mem_len", "mem_pos")}, False, False))
        if cfg.is_encdec:
            cache["mem_len"], cache["mem_pos"] = self._memory(enc_out)
        if self.n_attn:  # this rank's slots of a context-parallel cache
            n = cache["kv_pos"].shape[-1]
            _, j, split = model_split(n, cap)
            lo = j * n if split else 0
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        for layer, j in zip(params["layers"], self._slot, strict=True):
            mem = None
            if "cross" in layer:
                cache["cross_k"][j], cache["cross_v"][j] = attn.cross_memory(layer["cross"], cfg,
                                                                             enc_out)
                mem = self._mem_view(cache, j)
            x, new = tfm.block_prefill(layer, cfg, x, positions, mem)
            if "attn" in layer:  # the cache holds every KV head
                k, v = (model_gather(t, 2) if model_split(t.shape[2], cfg.n_kv_heads)[2] else t
                        for t in new)
                cache["k"][j], cache["v"][j], cache["kv_pos"][j] = attn.prefill_fill_cache(
                    k, v, lengths, cap, self.dtype, lo, n)
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
            layout = ssm.mamba_cache_layout(self.cfg, self.n_ssm, tokens.shape[0], self.dtype, T)
            cache.update(self._make({k: layout[k] for k in ssm.STEP_KEYS}, rows=False))
        x = embed_tokens(params["embedding"], tokens, self.cfg.padded_vocab)
        for layer, j in zip(params["layers"], self._slot, strict=True):
            names = _ATTN_KEYS if "attn" in layer else ssm.CACHE_KEYS + ssm.STEP_KEYS
            view = {name: cache[name][j] for name in names if name in cache}
            mem = self._mem_view(cache, j) if "cross" in layer else None
            x = tfm.block_decode(layer, self.cfg, x, view, cache["len"], cache.get("bt"), mem)
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
    def _mem_view(cache, j):
        """Layer j's cross memory as ``attention_cross`` takes it."""
        return (*(cache[name][j] for name in _CROSS_KEYS), cache["mem_len"], cache["mem_pos"])

    @staticmethod
    def commit_cache(cache, old_len, accept_idx):
        """Roll back to old_len + accept_idx + 1 committed tokens, in place.
        Attention caches rewind by pointer (stale slots stay masked); SSM
        layers take the state and conv window at ``accept_idx`` per row; the
        cross memory stays as it is."""
        if "states_all" in cache:
            rows = torch.arange(accept_idx.shape[0], device=accept_idx.device)
            idx = accept_idx.long()
            cache["state"].copy_(cache["states_all"][:, rows, idx])
            cache["conv"].copy_(cache["conv_all"][:, rows, idx])
        cache["len"].copy_(old_len + accept_idx + 1)


def resolve_device(device=None):
    """``None`` means the card.  Without CUDA that raises: the CPU is chosen
    explicitly (``device="cpu"``), never fallen back to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this machine; pass "
                           "device='cpu' to run the port on the CPU")
    return dev


def build_model(cfg, device="cuda"):
    """The model on ``device``, the card by default (``resolve_device``)."""
    return Model(cfg, resolve_device(device))
