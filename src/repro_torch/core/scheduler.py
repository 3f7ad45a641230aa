"""StreamScheduler — request orchestration (paper Alg 1); a copy of
``repro.core.scheduler`` without its StreamTrace events (recording is not
ported yet).

Receives requests, consults the router for placement, enqueues to the
selected stream pair's prefill queue, and tracks lifecycle transitions.
Dead workers are excluded from routing and their queued requests re-routed.

SLO control plane (``slo_routing=True``):

* **Routing** — submit() hands the router the request plus a per-worker
  queue-delay estimate (cost-model ticks of queued prefill work).
* **EDF ordering** — prefill queues drain earliest-deadline-first (deadline =
  arrival + slo_ttft; best-effort requests sort last, FIFO among themselves).
* **Admission guard** — a request whose deadline passed before service could
  start is shed: it finishes FAILED with ``error="slo_infeasible"``.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List, Protocol, Tuple

from repro_torch.core.flowguard import FlowGuard
from repro_torch.core.metrics import PerformanceMonitor, RequestRecord
from repro_torch.obs.spans import request_phases
from repro_torch.serving.request import Request, RequestState


class Router(Protocol):
    """A placement policy.  With ``slo_routing`` the scheduler passes the
    request and per-worker queue delays, and with paged KV the per-worker
    ``prefix_scores``, so a router must accept them."""

    def select(self, metrics, now, healthy=None, request=None,
               queue_delays=None, prefix_scores=None): ...


def edf_deadline(req):
    """EDF key: absolute TTFT deadline; best-effort requests sort last."""
    if req.slo_ttft is None:
        return math.inf
    # tick-0 arrivals are real measurements: `is not None`, never truthiness
    arrival = req.arrival_time if req.arrival_time is not None else 0.0
    return arrival + req.slo_ttft


class StreamScheduler:
    def __init__(self, n_pairs, router=None,
                 monitor=None, *,
                 slo_routing=False,
                 delay_estimator=None):
        self.router: Router = router or FlowGuard()
        self.monitor = monitor or PerformanceMonitor(n_pairs)
        self.prefill_queues: Dict[int, Deque[Request]] = {i: deque() for i in range(n_pairs)}
        self.healthy: Dict[int, bool] = {i: True for i in range(n_pairs)}
        self.routing_log: List[Tuple[str, int]] = []
        self.slo_routing = slo_routing
        self.delay_estimator = delay_estimator
        self.shed: List[Request] = []
        # chunked-prefill hooks (wired by the engine): requests parked in a
        # pair's chunk rows left the queue but still owe the lane ticks
        self.inflight_depth = None
        self.inflight_delay = None
        # paged-KV hook (wired by the engine): a pair's saved-prefill
        # fraction for a request, from its radix index
        self.prefix_probe = None

    def queue_delay(self, worker_id):
        """Estimated ticks of prefill service ahead of a new arrival: the
        queued requests plus the chunk rows' remaining backlog."""
        if self.delay_estimator is None:
            delay = float(len(self.prefill_queues[worker_id]))
        else:
            delay = sum(self.delay_estimator(r) for r in self.prefill_queues[worker_id])
        if self.inflight_delay is not None:
            delay += self.inflight_delay(worker_id)
        return delay

    def submit(self, req, now):
        healthy = [i for i, ok in self.healthy.items() if ok]
        # the router reads queue depth live — but a derived refresh must NOT
        # touch the staleness timestamp, or a silent worker looks fresh
        for i in healthy:
            self.monitor.update_worker(i, queue_depth=self.queue_depth(i), touch=False)
        extra = {}
        if self.prefix_probe is not None:
            extra["prefix_scores"] = {i: self.prefix_probe(i, req) for i in healthy}
        if self.slo_routing:
            extra.update(request=req, queue_delays={i: self.queue_delay(i) for i in healthy})
        worker, _ = self.router.select(self.monitor.snapshot(), now, healthy, **extra)
        req.worker_id = worker
        req.state = RequestState.QUEUED
        if req.arrival_time is None:  # an explicit t=0 arrival is legitimate
            req.arrival_time = now
        self.prefill_queues[worker].append(req)
        self.routing_log.append((req.request_id, worker))
        return worker

    def next_for_prefill(self, worker_id, now=None):
        """Pop the next request to prefill: FIFO without SLO routing; with
        it, earliest-deadline-first, shedding requests that can no longer
        make their deadline on the way."""
        q = self.prefill_queues[worker_id]
        while q:
            if not self.slo_routing:
                return q.popleft()
            idx = min(range(len(q)), key=lambda i: edf_deadline(q[i]))
            req = q[idx]
            del q[idx]
            if now is not None and req.slo_ttft is not None and now > edf_deadline(req):
                self.shed.append(req)
                self.fail_request(req, now, "slo_infeasible", slo_infeasible=True)
                continue
            return req
        return None

    def fail_request(self, req, now, reason,
                     slo_infeasible=False):
        """Terminal failure with a RequestRecord: a request never vanishes
        without a record, whatever path killed it."""
        req.state, req.error, req.t_end = RequestState.FAILED, reason, now
        queued, prefill, decode, stall = request_phases(req)
        self.monitor.complete_request(RequestRecord(
            request_id=req.request_id,
            t_start=req.arrival_time if req.arrival_time is not None else 0.0,
            t_end=now, prompt_len=req.prompt_len, generated=len(req.output_tokens),
            token_times=list(req.token_times), worker_id=req.worker_id,
            slo_ttft=req.slo_ttft, slo_tpot=req.slo_tpot, slo_infeasible=slo_infeasible,
            kv_requeued=req.kv_requeued, phase_queued=queued, phase_prefill=prefill,
            phase_decode=decode, phase_stall=stall))

    def queue_depth(self, worker_id):
        """Queued requests plus any parked mid-chunked-prefill on the pair."""
        depth = len(self.prefill_queues[worker_id])
        if self.inflight_depth is not None:
            depth += self.inflight_depth(worker_id)
        return depth

    def cancel(self, request_id):
        """Drop a still-queued request.  Returns it, or None if not queued."""
        for q in self.prefill_queues.values():
            for req in q:
                if req.request_id == request_id:
                    q.remove(req)
                    return req
        return None

    def resubmit_or_fail(self, req, now):
        """Re-route an orphaned request, or FAIL it with a record when no
        healthy worker remains to take it."""
        if any(self.healthy.values()):
            self.submit(req, now)
            return True
        self.fail_request(req, now, "no_healthy_workers")
        return False

    def mark_unhealthy(self, worker_id, now):
        """Exclude a dead worker from routing and re-route its queued
        requests.  Returns how many were re-routed."""
        self.healthy[worker_id] = False
        orphans = list(self.prefill_queues[worker_id])
        self.prefill_queues[worker_id].clear()
        return sum(self.resubmit_or_fail(req, now) for req in orphans)

    def pending_total(self):
        return sum(len(q) for q in self.prefill_queues.values())
