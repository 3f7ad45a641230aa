"""SpecuStream — runtime-adaptive speculation depth (paper §3.5, Alg 4).

Implements Eq 8–16 exactly:

  δ_t    = a_t − mean(f)                       (Eq 8)
  f[idx] = δ_t ;  idx = (idx+1) mod h           (circular update)
  M_f    = mean(|f|)                            (Eq 9)
  φ_tput = max(1, τ_target / max(τ_recent, 1))  (Eq 10)
  φ_load = 1 − min(l_w, 0.9)                    (Eq 11)
  d      = d_base + (a_t · M_f · γ) · φ_load · φ_tput   (Eq 12)
  d*     = clip(d, d_min, d_max)                (Eq 13)
  b_micro = max(1, ⌊16·5 / d*⌋)                 (Eq 14)
  τ_proj = τ_recent · (1 + a_t · 0.5)           (Eq 15)
  τ_recent ← 0.9·τ_recent + 0.1·τ_proj          (Eq 16)

The continuous d* is snapped to a bucket from ``DEPTH_BUCKETS`` (the largest
bucket <= d*), as in ``repro.core.specustream``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.registry import register_spec_policy

DEPTH_BUCKETS: Tuple[int, ...] = (2, 3, 4, 5, 6, 8, 10, 12, 16, 20)

# Traced-shape buckets for the speculative VERIFY step.  The policy above may
# pick any depth d; the engine pads the draft up to the smallest member >= d
# and masks the padding inside verify_tokens, so the decode lane compiles at
# most len(VERIFY_BUCKETS) verify shapes no matter how d moves step to step.
VERIFY_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8)


def pad_to_bucket(k, buckets):
    """Smallest shape bucket >= k (k itself when bucketing is off).

    ``k`` above the largest bucket is the caller's responsibility to clamp;
    here it maps to the largest bucket."""
    if not buckets:
        return k
    for b in buckets:
        if b >= k:
            return b
    return buckets[-1]


@dataclasses.dataclass(frozen=True)
class SpecuStreamConfig:
    d_base: float = 5.0          # baseline depth
    gamma: float = 5.0           # amplification factor γ
    d_min: int = 2
    d_max: int = 20
    history: int = 10            # flow vector length h
    target_throughput: float = 400.0  # τ_target tokens/s (paper example)
    ema_old: float = 0.9
    ema_new: float = 0.1


@dataclasses.dataclass(frozen=True)
class SlotSignals:
    """Per-slot runtime signals for per-row depth selection.

    ``tpot`` is the request's measured mean inter-token time (engine ticks on
    CPU, wall seconds on hardware); ``slo_tpot`` its target, None = best
    effort.  Acceptance is tracked inside the policy (per-slot EMA), so the
    engine only ships what the policy cannot observe itself.
    """

    slo_tpot: Optional[float] = None
    tpot: Optional[float] = None


def tpot_headroom(tpot, slo_tpot):
    """Normalised TPOT slack in [0, 1]: 1 = unconstrained / all headroom,
    0 = at or past the target.

    Before the first measurable inter-token gap the request is priced at the
    non-speculative rate (1 token per tick), so a target tighter than plain
    decoding starts conservative instead of optimistic.
    """
    if slo_tpot is None or slo_tpot <= 0.0:
        return 1.0
    measured = tpot if tpot is not None and tpot > 0.0 else 1.0
    return min(max((slo_tpot - measured) / slo_tpot, 0.0), 1.0)


@dataclasses.dataclass
class SpecDecision:
    depth: float                 # raw d* (Eq 13)
    bucket_depth: int            # snapped to DEPTH_BUCKETS
    micro_batch: int             # Eq 14
    projected_throughput: float  # Eq 15
    flow_magnitude: float        # M_f
    gradient: float              # δ_t


def snap_to_bucket(d, buckets=DEPTH_BUCKETS):
    """Largest bucket <= d (at least the smallest bucket)."""
    best = buckets[0]
    for b in buckets:
        if b <= d:
            best = b
    return best


class SpecuStream:
    """Per-worker adaptive speculation controller (one instance per decode
    lane; state = the flow vector + τ_recent)."""

    ACCEPT_PRIOR = 0.7  # optimistic prior for a freshly admitted slot

    def __init__(self, config=None):
        self.config = config or SpecuStreamConfig()
        self.flow: List[float] = [0.0] * self.config.history
        self.idx = 0
        self.tau_recent = self.config.target_throughput  # optimistic start
        self.last_decision: Optional[SpecDecision] = None
        # per-slot acceptance EMAs (per-request: reset on admit/finish)
        self.slot_acceptance: Dict[int, float] = {}

    # ------------------------------------------------------- per-slot state
    def observe_slot(self, slot, accepted_frac):
        """Fold one verify outcome into the slot's acceptance EMA."""
        prev = self.slot_acceptance.get(slot, self.ACCEPT_PRIOR)
        frac = min(max(accepted_frac, 0.0), 1.0)
        self.slot_acceptance[slot] = 0.8 * prev + 0.2 * frac

    def reset_slot(self, slot):
        """A new request took the slot (or it drained): drop its EMA."""
        self.slot_acceptance.pop(slot, None)

    def select_depths(
        self,
        signals,
        load,
        throughput,
    ):
        """Per-row depth selection (the AdaServe-style per-request control).

        Each occupied slot (``signals[i] is not None``) independently runs
        Eq 12–13 with its *own* acceptance EMA, then the continuous depth is
        interpolated between d_min and the raw value by the row's TPOT
        headroom — a request already at its ``slo_tpot`` target cannot afford
        deeper (more expensive, riskier) verify steps, while a relaxed one
        speculates to the full signal-driven depth.  Empty rows get 0.

        The shared flow state (volatility, τ_recent) is advanced by the
        engine's once-per-iteration :meth:`adapt` call, not here — this
        method is read-only on global state so the two stay composable.
        """
        c = self.config
        mag = self.last_decision.flow_magnitude if self.last_decision else 0.0
        scale = max(1.0, c.target_throughput / max(throughput, 1.0))  # Eq 10
        adj = 1.0 - min(max(load, 0.0), 0.9)                          # Eq 11
        depths = np.zeros(len(signals), np.int64)
        for i, sig in enumerate(signals):
            if sig is None:
                continue
            a = self.slot_acceptance.get(i, self.ACCEPT_PRIOR)
            d = c.d_base + (a * mag * c.gamma) * adj * scale          # Eq 12
            d = min(max(d, float(c.d_min)), float(c.d_max))           # Eq 13
            h = tpot_headroom(sig.tpot, sig.slo_tpot)
            depths[i] = snap_to_bucket(c.d_min + (d - c.d_min) * h)
        return depths

    # ------------------------------------------------------------- Alg 4
    def adapt(self, acceptance_rate, load, throughput):
        c = self.config
        a_t = min(max(acceptance_rate, 0.0), 1.0)
        # Eq 8 — gradient vs. recent history
        delta = a_t - sum(self.flow) / len(self.flow)
        self.flow[self.idx] = delta
        self.idx = (self.idx + 1) % c.history
        # Eq 9 — flow magnitude (volatility)
        mag = sum(abs(x) for x in self.flow) / len(self.flow)
        # Eq 10 — throughput scaling
        scale = max(1.0, c.target_throughput / max(throughput, 1.0))
        # Eq 11 — load adaptation
        adj = 1.0 - min(max(load, 0.0), 0.9)
        # Eq 12–13 — depth
        d = c.d_base + (a_t * mag * c.gamma) * adj * scale
        d_star = min(max(d, float(c.d_min)), float(c.d_max))
        # Eq 14 — inverse micro-batch coupling
        b_micro = max(1, int(16 * 5 / d_star))
        # Eq 15–16 — throughput projection
        t_proj = throughput * (1.0 + a_t * 0.5)
        self.tau_recent = c.ema_old * self.tau_recent + c.ema_new * t_proj
        decision = SpecDecision(
            depth=d_star,
            bucket_depth=snap_to_bucket(d_star),
            micro_batch=b_micro,
            projected_throughput=t_proj,
            flow_magnitude=mag,
            gradient=delta,
        )
        self.last_decision = decision
        return decision


class FixedSpeculation:
    """Ablation baseline: fixed depth d (paper Table 9) or d=0 (no spec,
    'w/o SpecuStream' in Table 8)."""

    def __init__(self, depth):
        self.depth = depth
        self.last_decision: Optional[SpecDecision] = None

    def observe_slot(self, slot, accepted_frac):
        pass

    def reset_slot(self, slot):
        pass

    def select_depths(
        self,
        signals,
        load,
        throughput,
    ):
        """Same fixed depth on every occupied row (SLO signals ignored)."""
        d = self.adapt(0.0, load, throughput).bucket_depth
        return np.array([0 if s is None else d for s in signals], np.int64)

    def adapt(self, acceptance_rate, load, throughput):
        d = max(self.depth, 0)
        decision = SpecDecision(
            depth=float(d),
            bucket_depth=snap_to_bucket(d) if d >= DEPTH_BUCKETS[0] else 0,
            micro_batch=max(1, int(16 * 5 / d)) if d > 0 else 16,
            projected_throughput=throughput,
            flow_magnitude=0.0,
            gradient=0.0,
        )
        self.last_decision = decision
        return decision


@register_spec_policy("specustream")
def _make_specustream(config=None, fixed_depth=5):
    if isinstance(config, dict):
        config = SpecuStreamConfig(**config)
    return SpecuStream(config)


@register_spec_policy("fixed")
def _make_fixed(config=None, fixed_depth=5):
    return FixedSpeculation(fixed_depth)


@register_spec_policy("none")
def _make_no_spec(config=None, fixed_depth=5):
    return FixedSpeculation(0)
