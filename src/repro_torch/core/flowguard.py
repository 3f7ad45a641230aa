"""FlowGuard — multi-signal metric-aware routing (paper §3.3, Alg 2), and
the round-robin ablation router; a copy of ``repro.core.flowguard``.

  Eq 1:  S_w = α1·C_w + α2·(1−M_w) + α3·(1−Q_w) + α4·(1−L_w)
  Eq 2:  Overload(w) = ω_w > τ
  Eq 3:  ω_w = M_w + 2·Q_w/Q_max            (M_w normalised to [0, 1])
  Eq 4:  w* = argmin_i Q_i  when every worker is overloaded (fallback)

Defaults are the paper's: α = (0.4, 0.1, 0.3, 0.2), τ = 0.85.
"""
from __future__ import annotations

import dataclasses

from repro_torch.api.registry import register_router
from repro_torch.core.metrics import STALENESS_S


@dataclasses.dataclass(frozen=True)
class FlowGuardConfig:
    alpha_cache: float = 0.4      # α1 — cache reuse
    alpha_memory: float = 0.1     # α2 — memory headroom
    alpha_queue: float = 0.3      # α3 — queue headroom
    alpha_load: float = 0.2       # α4 — load headroom
    overload_threshold: float = 0.85  # τ
    q_max: int = 16               # Q_max queue-depth normaliser
    staleness_s: float = STALENESS_S
    # additive TTFT-slack weight for SLO-carrying requests (zero for
    # best-effort traffic, so Eq 1 is unchanged when no SLOs are in play)
    slo_weight: float = 0.5
    # weight of the additive prefix-hit term (paged KV): the saved-prefill
    # fraction of a worker's resident radix prefix, 0 where none matches
    prefix_weight: float = 0.3

    def __post_init__(self):
        s = self.alpha_cache + self.alpha_memory + self.alpha_queue + self.alpha_load
        if abs(s - 1.0) > 1e-6:
            raise ValueError(f"routing weights must sum to 1 (got {s})")
        if self.slo_weight < 0.0 or self.prefix_weight < 0.0:
            raise ValueError("slo_weight and prefix_weight must be >= 0")


class FlowGuard:
    """Scorer + overload detector over a metrics snapshot.  ``last_breakdown``
    keeps the last ``select()``'s per-worker weighted terms (cache, memory,
    queue, load, slo, prefix)."""

    def __init__(self, config=None):
        self.config = config or FlowGuardConfig()
        self.last_breakdown = {}

    def score_terms(self, m):
        """Eq 1's four weighted terms (cache, memory, queue, load)."""
        c = self.config
        q_norm = min(m.queue_depth / c.q_max, 1.0)
        return (c.alpha_cache * m.cache_hit_rate, c.alpha_memory * (1.0 - m.memory_utilization),
                c.alpha_queue * (1.0 - q_norm), c.alpha_load * (1.0 - m.active_load))

    def is_overloaded(self, m):
        """Eq 2-3."""
        omega = m.memory_utilization + 2.0 * min(m.queue_depth / self.config.q_max, 1.0)
        return omega > self.config.overload_threshold

    def slo_slack_term(self, request, queue_delay, now):
        """TTFT slack (slo_ttft - elapsed - queue delay) normalised by the
        target, clipped to [-1, 1], times ``slo_weight``; 0 without a target."""
        slo = getattr(request, "slo_ttft", None) if request is not None else None
        if slo is None or slo <= 0.0:
            return 0.0
        arrival = getattr(request, "arrival_time", None)
        elapsed = max(now - arrival, 0.0) if arrival is not None else 0.0
        slack = slo - elapsed - max(queue_delay, 0.0)
        return self.config.slo_weight * min(max(slack / slo, -1.0), 1.0)

    def select(self, metrics, now, healthy=None, request=None, queue_delays=None,
               prefix_scores=None):
        """Pick the target stream pair (Alg 2).  Returns (worker_id, scores).

        Stale or overloaded candidates are skipped; when none is left, the
        least-loaded queue wins (Eq 4), preferring workers with fresh
        metrics.  With ``queue_delays`` SLO-carrying requests also steer
        toward the worker with the most TTFT slack, and ``prefix_scores``
        (worker -> saved-prefill fraction) pulls a request toward the worker
        holding its prefix by up to ``prefix_weight``.
        """
        candidates = list(metrics.keys() if healthy is None else healthy)
        if not candidates:
            raise RuntimeError("FlowGuard: no healthy workers")
        scores = {}
        self.last_breakdown = {}
        for i in candidates:
            m = metrics[i]
            if m.is_stale(now, self.config.staleness_s) or self.is_overloaded(m):
                continue
            terms = self.score_terms(m)
            slo_term = 0.0
            if queue_delays is not None:
                slo_term = self.slo_slack_term(request, queue_delays.get(i, 0.0), now)
            prefix_term = 0.0
            if prefix_scores is not None:
                prefix_term = self.config.prefix_weight * min(max(prefix_scores.get(i, 0.0),
                                                                  0.0), 1.0)
            scores[i] = sum(terms) + slo_term + prefix_term
            self.last_breakdown[i] = (*terms, slo_term, prefix_term)
        if not scores:
            fresh = [i for i in candidates
                     if not metrics[i].is_stale(now, self.config.staleness_s)]
            return min(fresh or candidates, key=lambda i: (metrics[i].queue_depth, i)), scores
        return max(scores, key=lambda i: (scores[i], -i)), scores


class RoundRobinRouter:
    """Ablation baseline (paper Table 8, 'w/ Round-Robin'): the healthy
    pairs in turn, blind to load, SLOs and prefixes."""

    def __init__(self):
        self._next = 0

    def select(self, metrics, now, healthy=None, request=None, queue_delays=None,
               prefix_scores=None):
        candidates = sorted(metrics.keys() if healthy is None else healthy)
        self._next += 1
        return candidates[(self._next - 1) % len(candidates)], {}


@register_router("flowguard")
def _make_flowguard(config=None):
    return FlowGuard(FlowGuardConfig(**config) if isinstance(config, dict) else config)


@register_router("roundrobin")
def _make_roundrobin(config=None):
    return RoundRobinRouter()
