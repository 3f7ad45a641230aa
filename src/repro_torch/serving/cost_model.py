"""Analytic per-operation cost model (the part of ``repro.serving.cost_model``
that SLO routing reads).

Every op costs ``max(compute_time, memory_time) + dispatch_overhead``: a
roofline max, since the device overlaps copies with compute.  The default
profile is one NVIDIA H100 SXM from NVIDIA's data sheet; its dispatch and
host-staging figures are planning values, not measurements.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float          # per lane, /s
    hbm_bw: float              # bytes/s per lane
    interconnect_bw: float     # bytes/s for KV transfer between lanes
    dispatch_overhead: float   # s per device step (kernel launch, host sync)
    host_staged_bw: float      # bytes/s for a host-staged transfer


H100_SXM = HardwareProfile(
    name="h100-sxm",
    peak_flops=989e12,         # dense bf16 tensor cores
    hbm_bw=3.35e12,
    interconnect_bw=450e9,     # NVLink, one direction
    dispatch_overhead=10e-6,
    host_staged_bw=25e9,       # PCIe gen5 x16, one direction
)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Prices engine ops for one (arch, hardware) deployment on a one-device
    lane (the reference's tensor-parallel lane terms are zero there)."""

    cfg: ArchConfig
    hw: HardwareProfile = H100_SXM
    mfu: float = 0.5             # achievable fraction of peak on matmuls
    bw_efficiency: float = 0.55  # achieved fraction of peak HBM bandwidth
    dtype_bytes: int = 2

    @property
    def n_active(self):
        return self.cfg.n_active_params()

    @property
    def flops_rate(self):
        return self.hw.peak_flops * self.mfu

    @property
    def mem_rate(self):
        return self.hw.hbm_bw * self.bw_efficiency

    def _n_attn(self):
        return sum(1 for k in self.cfg.layer_kinds() if k == "attn")

    def kv_bytes_per_token(self):
        return self._n_attn() * 2 * self.cfg.n_kv_heads * self.cfg.head_dim * self.dtype_bytes

    def ssm_state_bytes(self):
        """The fp32 SSD state of one sequence over all SSM layers."""
        s = self.cfg.ssm
        if s is None:
            return 0
        n_ssm = self.cfg.n_layers - self._n_attn()
        return n_ssm * s.n_heads(self.cfg.d_model) * s.head_dim * s.d_state * 4

    def prefill_time(self, prompt_len, cached_tokens=0):
        """One prompt through the prefill lane (compute-bound)."""
        live = max(prompt_len - cached_tokens, 0)
        flops = 2.0 * self.n_active * live
        attn_heads = self.cfg.n_heads * self.cfg.head_dim
        flops += 4.0 * self._n_attn() * live * max(live, 1) * attn_heads / 2
        t_memory = (self.n_active * self.dtype_bytes) / self.mem_rate
        return max(flops / self.flops_rate, t_memory) + self.hw.dispatch_overhead

    def decode_step_time(self, batch, mean_context, t_tokens=1):
        """One decode (or verify) iteration: weights once, KV and SSM state
        per sequence."""
        weight_bytes = self.n_active * self.dtype_bytes
        kv_bytes = batch * mean_context * self.kv_bytes_per_token()
        state_bytes = batch * self.ssm_state_bytes()
        t_memory = (weight_bytes + kv_bytes + state_bytes) / self.mem_rate
        t_compute = 2.0 * self.n_active * batch * t_tokens / self.flops_rate
        return max(t_compute, t_memory) + self.hw.dispatch_overhead

    def kv_transfer_time(self, prompt_len):
        """Prefill -> decode KV (and SSM state) handoff over the lanes' direct link."""
        nbytes = prompt_len * self.kv_bytes_per_token() + self.ssm_state_bytes()
        return nbytes / self.hw.interconnect_bw + self.hw.dispatch_overhead


class PrefillDelayEstimator:
    """Prices queued prefill work in engine-tick units for SLO routing: one
    tick is one batched decode step, so a queued prompt costs its prefill
    plus KV-transfer time over the decode-step time (at least 1 tick).  With
    chunked prefill the lane serves one ``prefill_chunk`` a tick, so a prompt
    costs ceil(prompt / chunk) ticks."""

    def __init__(self, cfg, hw=H100_SXM,
                 max_batch=8, mean_context=256, prefill_chunk=None):
        self.cost = CostModel(cfg, hw=hw)
        self.tick_s = self.cost.decode_step_time(max_batch, max(mean_context, 1))
        self.prefill_chunk = prefill_chunk

    def _chunks(self, n):
        return max(-(-n // self.prefill_chunk), 1)

    def ticks(self, req):
        """Estimated service ticks to prefill one queued request (memoised on
        the request: its prompt never changes while queued)."""
        cached = getattr(req, "_prefill_ticks", None)
        if cached is not None:
            return cached
        plen = len(req.prompt)
        if self.prefill_chunk:
            t = float(self._chunks(plen))
        else:
            t = self.cost.prefill_time(plen, getattr(req, "cache_hit_tokens", 0))
            t = max((t + self.cost.kv_transfer_time(plen)) / self.tick_s, 1.0)
        req._prefill_ticks = t
        return t

    def saved_ticks(self, prompt_len, hit_tokens):
        """Prefill ticks a resident prefix of ``hit_tokens`` saves a
        ``prompt_len`` prompt, in the units of :meth:`ticks`."""
        hit = min(max(hit_tokens, 0), prompt_len)
        if hit == 0:
            return 0.0
        if self.prefill_chunk:
            return float(self._chunks(prompt_len) - self._chunks(prompt_len - hit))
        rem = self.cost.prefill_time(prompt_len, cached_tokens=hit)
        return max(self.cost.prefill_time(prompt_len) - rem, 0.0) / self.tick_s

    def saved_frac(self, prompt_len, hit_tokens):
        """Prefill work a resident prefix of ``hit_tokens`` saves, as a
        fraction of the whole prompt's prefill in [0, 1]: FlowGuard's prefix
        term.  Where prefill is memory-bound the roofline delta is ~0 but the
        hit still skips work, so the token fraction stands in."""
        hit = min(max(hit_tokens, 0), prompt_len)
        if prompt_len <= 0 or hit == 0:
            return 0.0
        if self.prefill_chunk:
            full = float(self._chunks(prompt_len))
        else:
            full = self.cost.prefill_time(prompt_len) / self.tick_s
        frac = self.saved_ticks(prompt_len, hit) / full if full > 0.0 else 0.0
        return min(max(frac if frac > 0.0 else hit / prompt_len, 0.0), 1.0)
