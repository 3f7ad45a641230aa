"""Analytic per-operation cost model (a port of ``repro.serving.cost_model``):
what SLO routing reads and what the discrete-event simulator prices.

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

DRAFT_FRAC = 0.08             # the draft's size, a fraction of the target's
DRAFT_STEP_OVERHEAD = 0.6e-3  # s of launch latency a draft step


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Prices engine ops for one (arch, hardware, lane-width) deployment.  A
    lane of ``lane_chips`` devices splits the rates' work tensor-parallel and
    pays two activation all-reduces a layer (``tp_comm_time``, zero on one
    device)."""

    cfg: ArchConfig
    hw: HardwareProfile = H100_SXM
    lane_chips: int = 1          # devices per prefill/decode worker
    mfu: float = 0.5             # achievable fraction of peak on matmuls
    bw_efficiency: float = 0.55  # achieved fraction of peak HBM bandwidth
    tp_sync_latency: float = 40e-6  # per all-reduce within a lane: latency-bound at decode
    dtype_bytes: int = 2

    @property
    def n_params(self):
        return self.cfg.n_params()

    @property
    def n_active(self):
        return self.cfg.n_active_params()

    @property
    def flops_rate(self):
        return self.hw.peak_flops * self.lane_chips * self.mfu

    @property
    def mem_rate(self):
        return self.hw.hbm_bw * self.lane_chips * self.bw_efficiency

    def tp_comm_time(self, tokens):
        """Two activation all-reduces a layer within a tensor-parallel lane:
        latency-bound for decode, bandwidth-bound for prefill."""
        if self.lane_chips <= 1:
            return 0.0
        n_layers = self.cfg.n_layers + self.cfg.n_encoder_layers
        act_bytes = tokens * self.cfg.d_model * self.dtype_bytes
        ring = 2.0 * (self.lane_chips - 1) / self.lane_chips
        return 2.0 * n_layers * max(self.tp_sync_latency,
                                    act_bytes * ring / self.hw.interconnect_bw)

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

    def _step_time(self, n, context):
        """n tokens through the lane, attending to ``context`` positions:
        compute or one weight stream, the lane's all-reduces, a dispatch."""
        flops = 2.0 * self.n_active * n
        heads = self.cfg.n_heads * self.cfg.head_dim
        flops += 4.0 * self._n_attn() * n * max(context, 1) * heads / 2
        t_memory = (self.n_active * self.dtype_bytes) / self.mem_rate
        return (max(flops / self.flops_rate, t_memory) + self.tp_comm_time(n)
                + self.hw.dispatch_overhead)

    def prefill_time(self, prompt_len, cached_tokens=0):
        """One prompt through the prefill lane (compute-bound)."""
        live = max(prompt_len - cached_tokens, 0)
        return self._step_time(live, live)

    def chunked_prefill_time(self, prompt_len, chunk, cached_tokens=0):
        """Prefill as ceil(L / chunk) chunk steps: each streams the weights
        again and attends to the prefix ingested so far plus itself, so
        chunking costs a dispatch and a weight stream a chunk."""
        live, chunk = max(prompt_len - cached_tokens, 0), max(chunk, 1)
        total = 0.0  # in order: sum() compensates its rounding
        for done in range(0, live, chunk):
            total += self._step_time(min(chunk, live - done), min(done + chunk, live))
        return total or self.hw.dispatch_overhead

    def decode_step_time(self, batch, mean_context, t_tokens=1):
        """One decode (or verify) iteration: weights once, KV and SSM state
        per sequence."""
        weight_bytes = self.n_active * self.dtype_bytes
        kv_bytes = batch * mean_context * self.kv_bytes_per_token()
        state_bytes = batch * self.ssm_state_bytes()
        t_memory = (weight_bytes + kv_bytes + state_bytes) / self.mem_rate
        t_compute = 2.0 * self.n_active * batch * t_tokens / self.flops_rate
        return (max(t_compute, t_memory) + self.tp_comm_time(batch * t_tokens)
                + self.hw.dispatch_overhead)

    def draft_time(self, k_tokens):
        """k sequential steps of a draft ``DRAFT_FRAC`` the target's size; the
        per-step launch latency is what makes depth costly."""
        per_step = (self.n_active * self.dtype_bytes * DRAFT_FRAC / self.mem_rate
                    + DRAFT_STEP_OVERHEAD)
        return k_tokens * per_step

    def kv_transfer_time(self, prompt_len, nixl=True):
        """Prefill -> decode KV (and SSM state) handoff: over NVLink between
        the lanes, or (``nixl=False``) staged through host memory."""
        nbytes = prompt_len * self.kv_bytes_per_token() + self.ssm_state_bytes()
        bw = self.hw.interconnect_bw if nixl else self.hw.host_staged_bw
        return nbytes / bw + self.hw.dispatch_overhead


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
