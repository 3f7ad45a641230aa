"""`ServeConfig` — the one validated configuration object for the stack
(the fields, defaults and checks of ``repro.api.config.ServeConfig``).

    cfg = ServeConfig.reduced_smoke()            # the CPU test preset
    cfg = cfg.replace(max_batch=4)               # validated copy-update
    arch = cfg.build_arch_config()               # -> ArchConfig
    econf = cfg.build_engine_config()            # -> EngineConfig

Policy fields (``router``, ``draft``, ``spec_policy``) are registry names
(:mod:`repro_torch.api.registry`).  Fields of features the port does not
have yet (the gateway, StreamTrace) keep the reference's defaults and are
not validated here: the engine refuses a non-default trace setting by name.  The paged fields are checked by the engine's
paged gate.  YAML round trips are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.api.registry import DRAFTS, ROUTERS, SPEC_POLICIES
from repro_torch.core.flowguard import FlowGuardConfig
from repro_torch.core.specustream import VERIFY_BUCKETS, SpecuStreamConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    # ---- model ------------------------------------------------------------
    arch: str = "qwen3-1.7b"         # name in repro_torch.configs.ARCHS
    reduced: bool = True             # reduced_config() for CPU tests; False = full width
    n_layers: Optional[int] = None   # optional layer-count override
    # ---- topology and engine ----------------------------------------------
    n_pairs: int = 2                 # disaggregated stream pairs
    max_batch: int = 8               # decode slots per pair
    max_len: int = 512               # per-slot KV capacity (tokens)
    temperature: float = 0.0
    kv_blocks: int = 4096
    kv_block_size: int = 16
    # ---- policies (registry names) ----------------------------------------
    router: str = "flowguard"
    flowguard: Optional[FlowGuardConfig] = None
    draft: str = "ngram"
    max_ngram: int = 4
    draft_layers: int = 2            # layer count of the small 'model' draft
    spec_policy: str = "specustream"
    fixed_depth: int = 5
    spec: Optional[SpecuStreamConfig] = None
    # ---- hot-path shape bucketing ------------------------------------------
    prefill_buckets: bool = True     # pow2 prompt-length buckets + fused admits
    prefill_bucket_min: int = 16
    admit_batch: int = 4             # max admissions fused into one prefill call
    verify_buckets: Optional[Tuple[int, ...]] = VERIFY_BUCKETS
    prefill_chunk: Optional[int] = None  # chunked prefill: tokens a chunk; None = one-shot
    prefill_preempt: bool = True     # EDF preemption at chunk boundaries
    # ---- paged KV + radix prefix reuse ---------------------------------------
    paged_kv: bool = False           # global page pool + per-row block tables
    max_context: Optional[int] = None  # per-sequence ceiling when paged; None = max_len
    kv_evict_policy: str = "requeue"  # pool dry mid-decode: "requeue" or "truncate"
    # ---- SLO control plane ------------------------------------------------
    per_row_depth: bool = True       # per-slot speculation depths
    slo_routing: bool = True         # TTFT-slack routing + EDF + shed guard
    # ---- HTTP gateway (not ported yet) --------------------------------------
    gateway_host: str = "127.0.0.1"
    gateway_port: int = 8080
    gateway_max_pending: int = 256
    # ---- StreamTrace (recording not ported yet) -----------------------------
    trace: str = "off"
    trace_capacity: int = 4096
    trace_dir: Optional[str] = None
    # ---- workload defaults ------------------------------------------------
    max_new_tokens: int = 64         # default SamplingParams.max_new_tokens
    seed: int = 0

    def __post_init__(self):
        from repro_torch.configs import ARCHS

        for what, value, names in (("arch", self.arch, ARCHS), ("router", self.router, ROUTERS),
                                   ("draft", self.draft, DRAFTS),
                                   ("spec_policy", self.spec_policy, SPEC_POLICIES)):
            if value not in names:
                raise ValueError(f"unknown {what} {value!r}")
        for field, lo in [
            ("n_pairs", 1), ("max_batch", 1), ("max_len", 8), ("kv_blocks", 1),
            ("kv_block_size", 1), ("max_ngram", 1), ("draft_layers", 1),
            ("fixed_depth", 0), ("max_new_tokens", 1), ("prefill_bucket_min", 1),
            ("admit_batch", 1),
        ]:
            v = getattr(self, field)
            if not isinstance(v, int) or v < lo:
                raise ValueError(f"{field} must be an int >= {lo} (got {v!r})")
        if self.prefill_chunk is not None and (
                not isinstance(self.prefill_chunk, int) or self.prefill_chunk < 8
                or self.prefill_chunk > self.max_len):
            raise ValueError(f"prefill_chunk must be an int in [8, max_len] or None "
                             f"(got {self.prefill_chunk!r}, max_len {self.max_len})")
        for field in ("per_row_depth", "slo_routing", "prefill_buckets",
                      "prefill_preempt", "reduced", "paged_kv"):
            if not isinstance(getattr(self, field), bool):
                raise ValueError(f"{field} must be a bool (got {getattr(self, field)!r})")
        if self.verify_buckets is not None:
            vb = tuple(self.verify_buckets)
            if not vb or any(not isinstance(b, int) or b < 1 for b in vb) \
                    or list(vb) != sorted(set(vb)):
                raise ValueError(f"verify_buckets must be strictly increasing ints >= 1 "
                                 f"(got {self.verify_buckets!r})")
            object.__setattr__(self, "verify_buckets", vb)
        for ok, msg in ((self.temperature >= 0.0, "temperature must be >= 0"),
                        (self.n_layers is None or self.n_layers >= 1,
                         "n_layers override must be >= 1"),
                        (self.max_new_tokens < self.max_len,
                         "max_new_tokens must leave prompt room under max_len"),
                        (not (self.paged_kv and self.draft == "model"),
                         "paged_kv does not support the 'model' draft (the draft lane keeps "
                         "a dense cache with its own admission path)")):
            if not ok:
                raise ValueError(msg)

    def replace(self, **updates):
        """Copy-update with re-validation (the builder step)."""
        return dataclasses.replace(self, **updates)

    @classmethod
    def reduced_smoke(cls, arch="qwen3-1.7b", **overrides):
        """Tiny CPU configuration (the reference's preset)."""
        base = {"arch": arch, "reduced": True, "n_layers": 2, "n_pairs": 2, "max_batch": 3,
                "max_len": 96, "max_new_tokens": 12, "kv_blocks": 1024, "kv_block_size": 8}
        return cls(**{**base, **overrides})

    @classmethod
    def paper_stream_pairs(cls, arch="qwen3-1.7b", **overrides):
        """The paper's §4 operating point: 2 stream pairs, FlowGuard +
        SpecuStream, the full-size model (the reference's preset)."""
        base = {"arch": arch, "reduced": False, "n_pairs": 2, "max_batch": 16,
                "max_len": 2048, "max_new_tokens": 512, "kv_blocks": 8192}
        return cls(**{**base, **overrides})

    @classmethod
    def ablation_fixed_depth(cls, depth, arch="qwen3-1.7b", **overrides):
        """Table 8/9 ablation row: fixed speculation depth (0 disables)."""
        base = {"arch": arch, "spec_policy": "fixed" if depth > 0 else "none",
                "fixed_depth": max(depth, 0), "draft": "ngram" if depth > 0 else "none",
                **overrides}
        return cls.reduced_smoke(**base) if base.get("reduced", True) else cls(**base)

    def build_arch_config(self):
        from repro_torch.configs import get_config, reduced_config

        cfg = reduced_config(self.arch) if self.reduced else get_config(self.arch)
        if self.n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=self.n_layers)
        return cfg

    def build_draft_arch_config(self):
        """Arch config of the small 'model' draft: the same family with
        ``draft_layers`` layers (at most the target's)."""
        base = self.build_arch_config()
        return dataclasses.replace(base, n_layers=min(self.draft_layers, base.n_layers),
                                   name=base.name + "-draft")

    def build_engine_config(self):
        """EngineConfig from the fields both share, plus the three renamed."""
        from repro_torch.core.engine import EngineConfig

        shared = ({f.name for f in dataclasses.fields(EngineConfig)}
                  & {f.name for f in dataclasses.fields(self)})
        return EngineConfig(adaptive=self.spec_policy == "specustream", spec_config=self.spec,
                            router_config=self.flowguard,
                            **{name: getattr(self, name) for name in sorted(shared)})
