"""Performance Monitor (paper §3.6) — the shared metric infrastructure that
FlowGuard and SpecuStream both read ("joint adaptation", §1).

All metrics are normalised to [0, 1] where the paper requires it (Table 2).
Time is injected through a ``clock`` callable so the discrete-event simulator
and the real engine drive the same code.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Dict, List, Optional

METRIC_INTERVAL_S = 0.5  # paper: 500 ms collection cadence
STALENESS_S = 5 * METRIC_INTERVAL_S


@dataclasses.dataclass
class WorkerMetrics:
    """Snapshot of one stream pair's runtime signals (paper Table 2)."""

    worker_id: int
    cache_hit_rate: float = 0.0       # C_w  in [0,1]
    memory_utilization: float = 0.0   # M_w  in [0,1]
    queue_depth: int = 0              # raw queue depth (normalised by Q_max)
    active_load: float = 0.0          # L_w  in [0,1]
    acceptance_rate: float = 0.0      # a_t  in [0,1]
    recent_throughput: float = 0.0    # tokens/s
    timestamp: float = 0.0

    def is_stale(self, now, horizon=STALENESS_S):
        return (now - self.timestamp) > horizon


@dataclasses.dataclass
class RequestRecord:
    """Per-request measurements (paper Eq 17–19)."""

    request_id: str
    t_start: float
    t_end: float = 0.0
    prompt_len: int = 0
    generated: int = 0
    token_times: List[float] = dataclasses.field(default_factory=list)
    worker_id: int = -1
    # the sequence was truncated mid-decode because the KV block pool ran dry
    # (finished gracefully rather than over-committing accounting)
    kv_evicted: bool = False
    # times the paged pool evicted + re-queued this request mid-decode
    # (continuous batching under memory pressure; 0 on the dense path)
    kv_requeued: int = 0
    # ---- SLO control plane ------------------------------------------------
    slo_ttft: Optional[float] = None   # targets carried by the request
    slo_tpot: Optional[float] = None
    # shed by the admission guard: its TTFT slack was already negative when a
    # prefill slot opened, so serving it could only miss (and hurt others)
    slo_infeasible: bool = False
    # terminal cancellation (client-initiated); excluded from attainment
    cancelled: bool = False
    # mean per-row speculation depth over the request's verify steps
    mean_depth: float = 0.0
    # ---- phase-attributed latency (StreamTrace span assembly) -------------
    # queued + prefill + decode + stall == latency, all in engine ticks; see
    # repro_torch.obs.spans.compute_phases for the attribution rules
    phase_queued: float = 0.0
    phase_prefill: float = 0.0
    phase_decode: float = 0.0
    phase_stall: float = 0.0

    @property
    def latency(self):
        """Eq 17: end-to-end latency."""
        return self.t_end - self.t_start

    @property
    def tpot(self):
        """Eq 18: mean inter-token time over generated tokens."""
        if len(self.token_times) < 2:
            return 0.0
        gaps = [b - a for a, b in zip(self.token_times, self.token_times[1:], strict=False)]
        return sum(gaps) / len(gaps)

    @property
    def ttft(self):
        """Time to first token (queueing + prefill + KV transfer)."""
        if not self.token_times:
            return self.latency
        return self.token_times[0] - self.t_start

    @property
    def throughput(self):
        """Eq 19: (prompt + generated) tokens / latency."""
        lat = self.latency
        return (self.prompt_len + self.generated) / lat if lat > 0 else 0.0

    @property
    def ttft_ok(self):
        """TTFT attainment: None when no target; shed requests always miss."""
        if self.slo_ttft is None:
            return None
        if self.slo_infeasible or not self.token_times:
            return False
        return self.ttft <= self.slo_ttft

    @property
    def tpot_ok(self):
        """TPOT attainment: None when no target; <2 tokens attains trivially."""
        if self.slo_tpot is None:
            return None
        if self.slo_infeasible:
            return False
        return self.tpot <= self.slo_tpot


class PerformanceMonitor:
    """Collects worker metrics at the paper's 500 ms cadence and exposes the
    closed-loop feedback stream consumed by FlowGuard and SpecuStream."""

    def __init__(self, n_workers, clock=None):
        self.clock = clock or time.monotonic
        self.workers: Dict[int, WorkerMetrics] = {
            i: WorkerMetrics(worker_id=i, timestamp=self.clock()) for i in range(n_workers)
        }
        self.completed: List[RequestRecord] = []
        self._tput_window = {i: deque() for i in range(n_workers)}  # (tick, tokens)

    # ------------------------------------------------------------- updates
    def update_worker(self, worker_id, *, touch=True, **kwargs):
        """Set metric fields on a worker snapshot.

        ``touch=False`` updates values WITHOUT refreshing the staleness
        timestamp — for derived refreshes (e.g. the scheduler re-reading
        queue depth at routing time) that must not make a silent worker look
        freshly reported (``is_stale`` would never fire).
        """
        m = self.workers[worker_id]
        for k, v in kwargs.items():
            setattr(m, k, v)
        if touch:
            m.timestamp = self.clock()

    def record_tokens(self, worker_id, n_tokens, now=None):
        now = self.clock() if now is None else now
        win = self._tput_window[worker_id]
        win.append((now, n_tokens))
        horizon = now - 2.0
        while win and win[0][0] < horizon:
            win.popleft()
        total = sum(n for _, n in win)
        span = max(now - win[0][0], METRIC_INTERVAL_S) if win else METRIC_INTERVAL_S
        self.workers[worker_id].recent_throughput = total / span
        self.workers[worker_id].timestamp = now

    def complete_request(self, rec):
        self.completed.append(rec)

    # ------------------------------------------------------------- queries
    def snapshot(self):
        return {i: dataclasses.replace(m) for i, m in self.workers.items()}

    # ------------------------------------------------------------- summary
    def summary(self):
        recs = self.completed
        if not recs:
            return {}
        # latency/throughput aggregates describe SERVED traffic: cancelled
        # and admission-shed records are counted separately, not averaged in
        # (a shed record's "latency" is pure queueing and would skew p50)
        served = [r for r in recs if not r.cancelled and not r.slo_infeasible]
        if not served:
            served = recs  # degenerate: nothing served; keep the keys total
        lats = sorted(r.latency for r in served)
        ttfts = sorted(r.ttft for r in served)
        tpots = [r.tpot for r in served if r.tpot > 0]
        tputs = [r.throughput for r in served]

        def pct(vals, p):
            # nearest-rank percentile: ceil(p/100 * n) - 1.  The previous
            # int(p/100 * n) index read one rank high on exact multiples
            # (p50 of 4 samples -> index 2 instead of 1)
            idx = max(math.ceil(p / 100.0 * len(vals)) - 1, 0)
            return vals[idx]

        t0 = min(r.t_start for r in served)
        t1 = max(r.t_end for r in served)
        total_tokens = sum(r.prompt_len + r.generated for r in served)
        # SLO attainment over records that carry a target (cancelled requests
        # are the client's choice, not a serving miss — excluded)
        ttft_judged = [r.ttft_ok for r in recs if not r.cancelled
                       and r.ttft_ok is not None]
        tpot_judged = [r.tpot_ok for r in recs if not r.cancelled
                       and r.tpot_ok is not None]
        return {
            "slo_ttft_attainment": sum(ttft_judged) / len(ttft_judged) if ttft_judged else 1.0,
            "slo_tpot_attainment": sum(tpot_judged) / len(tpot_judged) if tpot_judged else 1.0,
            "slo_infeasible": sum(r.slo_infeasible for r in recs),
            "cancelled": sum(r.cancelled for r in recs),
            "n": len(recs),
            "latency_mean": sum(lats) / len(lats),
            **{f"latency_p{p}": pct(lats, p) for p in (50, 90, 95, 99)},
            "ttft_mean": sum(ttfts) / len(ttfts),
            **{f"ttft_p{p}": pct(ttfts, p) for p in (50, 99)},
            "tpot_mean": sum(tpots) / len(tpots) if tpots else 0.0,
            # phase-attributed latency means (queued + prefill + decode +
            # stall == latency per request)
            **{f"phase_{ph}_mean": sum(getattr(r, f"phase_{ph}") for r in served) / len(served)
               for ph in ("queued", "prefill", "decode", "stall")},
            "throughput_mean": sum(tputs) / len(tputs) if tputs else 0.0,
            "aggregate_tput": total_tokens / max(t1 - t0, 1e-9),
            "makespan": t1 - t0,
        }
