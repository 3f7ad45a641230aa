"""Discrete-event serving simulator (a port of ``repro.serving.simulator``).

Drives the port's real control plane (StreamScheduler, FlowGuard,
SpecuStream, PerformanceMonitor, KVCacheManager) against the analytic cost
model: every routing and speculation decision is the engine's own code, and
only device time is modelled.  Its times are model predictions from a
hardware profile (``H100_SXM`` by default, data-sheet planning values),
never measurements of a device.

Three deployment shapes (paper §4.1):

``streamserve``  N disaggregated stream pairs: a prefill lane and a decode
                 lane per pair, FlowGuard routing, SpecuStream adaptive
                 speculation, NVLink KV transfer between the lanes (or,
                 with ``nixl=False``, host-staged).
``monolithic``   vLLM-style single-lane workers: prefill shares the lane
                 with decode and blocks it (no chunked prefill), the
                 head-of-line effect of the paper's baselines under load.
Tensor- and data-parallel baselines differ only in lane count and width:
``vllm-tp`` is one monolithic worker on all devices, ``vllm-dp`` one
monolithic worker per device.

Speculation is sampled from each request's latent AR(1) acceptance process
(``data/workloads.py``): a verify step of depth k accepts a geometric prefix
of the k draft tokens, as the engine's ``verify_tokens`` does.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.api.registry import resolve_router
from repro_torch.core.flowguard import FlowGuard, FlowGuardConfig, RoundRobinRouter
from repro_torch.core.metrics import PerformanceMonitor, RequestRecord, WorkerMetrics
from repro_torch.core.scheduler import StreamScheduler
from repro_torch.core.specustream import FixedSpeculation, SpecuStream, SpecuStreamConfig
from repro_torch.data.workloads import SimRequest
from repro_torch.serving.cost_model import H100_SXM, CostModel
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.request import RequestState


@dataclasses.dataclass
class SimConfig:
    """One deployment configuration (paper Tables 3–9 rows)."""

    mode: str = "streamserve"        # streamserve | monolithic
    n_workers: int = 2               # stream pairs (or monolithic workers)
    lane_chips: int = 1              # devices per lane
    router: str = "flowguard"        # flowguard | roundrobin | random
    speculative: bool = True
    adaptive: bool = True            # SpecuStream vs fixed depth
    fixed_depth: int = 5
    nixl: bool = True                # NVLink KV transfer vs host-staged
    max_batch: int = 16
    kv_blocks: int = 2048
    kv_block_size: int = 16
    spec_config: Optional[SpecuStreamConfig] = None
    flowguard_config: Optional[FlowGuardConfig] = None
    seed: int = 0
    # Host-side engine overhead per scheduler/executor iteration: vLLM
    # v0.4.x's Python engine loop is reported at ~20-40 ms an iteration at
    # low batch; StreamServe's bucketed steps on dedicated lanes run a ~2 ms
    # control loop.  This constant reconciles the paper's stable-TPOT row
    # with its 11-18x latency gap.
    engine_overhead: float = 2e-3


class _RandomRouter:
    """'w/o FlowGuard' ablation: uniform random placement."""

    def __init__(self, seed=0):
        self.rng = np.random.default_rng(seed)

    def select(self, metrics, now, healthy=None):
        cands = sorted(metrics.keys() if healthy is None else healthy)
        return int(self.rng.choice(cands)), {}


@dataclasses.dataclass
class _Slot:
    sim: SimRequest
    context: int          # committed tokens (prompt + generated)
    generated: int = 0


class _Worker:
    """One stream pair (or monolithic worker) timeline."""

    def __init__(self, wid, sim):
        self.wid = wid
        self.sim = sim
        self.kv = KVCacheManager(sim.config.kv_blocks, sim.config.kv_block_size)
        c = sim.config
        self.spec = (SpecuStream(c.spec_config) if c.speculative and c.adaptive
                     else FixedSpeculation(c.fixed_depth if c.speculative else 0))
        self.slots = []
        self.acceptance = 0.7
        self.prefill_busy_until = 0.0
        self.decode_busy_until = 0.0
        self.decode_scheduled = False
        self.kick_at = -1.0          # pending prefill-retry event time
        self.healthy = True
        # monolithic: prefill occupies the single lane
        self.lane_busy_until = 0.0

    @property
    def load(self):
        return len(self.slots) / self.sim.config.max_batch

    def publish(self, now):
        self.sim.monitor.update_worker(
            self.wid,
            cache_hit_rate=self.kv.hit_rate,
            memory_utilization=self.kv.memory_utilization,
            queue_depth=self.sim.scheduler.queue_depth(self.wid),
            active_load=self.load,
            acceptance_rate=self.acceptance,
        )


class ServeSimulator:
    """Event-driven serving run over a request trace."""

    def __init__(self, cfg, config=None, hw=H100_SXM):
        self.cfg = cfg
        self.config = config or SimConfig()
        self.cost = CostModel(cfg, hw=hw, lane_chips=self.config.lane_chips)
        self.now = 0.0
        self.monitor = PerformanceMonitor(self.config.n_workers, clock=lambda: self.now)
        c = self.config  # plugin routers registered through repro_torch.api work here too
        router = {"flowguard": lambda: FlowGuard(c.flowguard_config), "roundrobin": RoundRobinRouter,
                  "random": lambda: _RandomRouter(c.seed)}.get(
                      c.router, lambda: resolve_router(c.router))()
        self.scheduler = StreamScheduler(self.config.n_workers, router, self.monitor)
        self.workers = [_Worker(i, self) for i in range(self.config.n_workers)]
        self.rng = np.random.default_rng(self.config.seed)
        self._events = []  # (t, seq, kind, payload)
        self._eid = itertools.count()
        self._sim_by_id = {}
        self.trace = []

    # ------------------------------------------------------------- plumbing
    def _push(self, t, kind, payload):
        heapq.heappush(self._events, (t, next(self._eid), kind, payload))

    ARRIVE, PREFILL_DONE, DECODE_TICK, FAIL, KICK = 0, 1, 2, 3, 4

    def inject_failure(self, t, wid):
        self._push(t, self.FAIL, (wid,))

    def add_worker(self):
        """Elastic scale-up: a new stream pair joins the routing pool."""
        wid = len(self.workers)
        self.monitor.workers[wid] = WorkerMetrics(worker_id=wid, timestamp=self.now)
        self.monitor._tput_window[wid] = deque()
        self.scheduler.prefill_queues[wid] = deque()
        self.scheduler.healthy[wid] = True
        self.config.n_workers += 1
        self.workers.append(_Worker(wid, self))
        # bootstrap metrics so the router sees the new pair immediately
        self.workers[wid].publish(self.now)
        return wid

    # ---------------------------------------------------------------- run
    def run(self, requests, until=1e9):
        for sim in requests:
            self._sim_by_id[sim.request.request_id] = sim
            self._push(sim.arrival, self.ARRIVE, (sim.request.request_id,))
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            if t > until:
                break
            self.now = max(self.now, t)
            (self._on_arrive, self._on_prefill_done, self._on_decode_tick, self._on_fail,
             self._on_kick)[kind](*payload)
        return self.monitor.summary()

    def _on_kick(self, wid):
        self.workers[wid].kick_at = -1.0
        self._maybe_start_prefill(wid)

    # ---------------------------------------------------------------- events
    def _on_arrive(self, rid):
        sim = self._sim_by_id[rid]
        wid = self.scheduler.submit(sim.request, self.now)
        self.workers[wid].publish(self.now)
        self._maybe_start_prefill(wid)

    def _kick_later(self, wid, at):
        w = self.workers[wid]
        at = max(at, self.now + 1e-9)
        if w.kick_at < 0 or at < w.kick_at:
            w.kick_at = at
            self._push(at, self.KICK, (wid,))

    def _maybe_start_prefill(self, wid):
        w = self.workers[wid]
        if not w.healthy:
            return
        if self.scheduler.queue_depth(wid) == 0:
            return
        mono = self.config.mode == "monolithic"
        busy = w.lane_busy_until if mono else w.prefill_busy_until
        if busy > self.now:
            self._kick_later(wid, busy)  # retry the moment the lane frees
            return
        if len(w.slots) >= self.config.max_batch:
            return  # no decode slot to hand into — retried on completions
        req = self.scheduler.next_for_prefill(wid)
        if req is None:
            return
        alloc = w.kv.allocate_sequence(
            req.request_id, list(req.prompt), extra_tokens=req.params.max_new_tokens
        )
        if alloc is None:  # KV exhausted: requeue, retry on next completion
            self.scheduler.prefill_queues[wid].appendleft(req)
            return
        cached = alloc.shared_blocks * w.kv.block_size
        req.state = RequestState.PREFILLING
        req.t_prefill_start = self.now
        t_pf = (
            self.cost.prefill_time(req.prompt_len, cached_tokens=cached)
            + self.config.engine_overhead
        )
        t_tx = self.cost.kv_transfer_time(req.prompt_len, nixl=self.config.nixl)
        if mono:
            # prefill occupies the ONLY lane: decode blocked (HOL effect)
            w.lane_busy_until = self.now + t_pf
            self._push(self.now + t_pf, self.PREFILL_DONE, (wid, req.request_id, 0.0))
        else:
            w.prefill_busy_until = self.now + t_pf
            self._push(self.now + t_pf, self.PREFILL_DONE, (wid, req.request_id, t_tx))

    def _on_prefill_done(self, wid, rid, t_tx):
        w = self.workers[wid]
        sim = self._sim_by_id[rid]
        req = sim.request
        if not w.healthy:
            # worker died mid-prefill: restart the request elsewhere (FAILED
            # with a record when no healthy worker remains to take it)
            w.kv.free_sequence(rid)
            req.output_tokens.clear()
            req.token_times.clear()
            req.state = RequestState.QUEUED
            if self.scheduler.resubmit_or_fail(req, self.now):
                self._maybe_start_prefill(req.worker_id)
            return
        req.t_prefill_end = self.now
        # KV transfer to the decode lane (zero for monolithic: same memory)
        join_at = self.now + t_tx
        req.state = RequestState.DECODING
        req.t_first_token = join_at
        req.output_tokens.append(0)
        req.token_times.append(join_at)
        w.slots.append(_Slot(sim, context=req.prompt_len + 1, generated=1))
        w.publish(self.now)
        self._maybe_start_prefill(wid)
        self._schedule_decode(wid, join_at)

    def _schedule_decode(self, wid, at):
        w = self.workers[wid]
        if not w.decode_scheduled and w.slots:
            w.decode_scheduled = True
            self._push(max(at, self.now), self.DECODE_TICK, (wid,))

    def _on_decode_tick(self, wid):
        w = self.workers[wid]
        w.decode_scheduled = False
        if not w.healthy or not w.slots:
            return
        mono = self.config.mode == "monolithic"
        start = max(self.now, w.lane_busy_until if mono else w.decode_busy_until)

        observed = self.monitor.workers[wid].recent_throughput
        if observed <= 0.0:  # cold start: optimistic prior (matches τ_recent init)
            observed = getattr(w.spec, "tau_recent", 400.0)
        decision = w.spec.adapt(w.acceptance, w.load, observed)
        k = decision.bucket_depth if self.config.speculative else 0
        live = w.slots
        B = len(live)
        mean_ctx = float(np.mean([s.context for s in live]))
        # Verify step: weights stream once (micro-batches per Eq 14 pipeline
        # back-to-back); depth costs show up as (a) k sequential draft steps
        # and (b) verify compute growing with B*(k+1) until it passes the
        # memory roofline — both modeled in the cost layer.
        t_iter = (
            self.cost.decode_step_time(B, mean_ctx, t_tokens=k + 1)
            + self.config.engine_overhead
        )
        if k > 0:
            t_iter += self.cost.draft_time(k)
        end = start + t_iter

        emitted = 0
        acc_samples = []
        finished = []
        for slot in live:
            a_t = slot.sim.acceptance.step(self.rng)
            acc_samples.append(a_t)
            n_acc = 0
            # acceptance decays with draft position: later draft tokens are
            # conditioned on a speculative prefix (EAGLE-style drafts measure
            # this), which is what makes over-speculation unprofitable
            # (paper Table 9, d=7)
            while n_acc < k and self.rng.uniform() < a_t * (0.93 ** n_acc):
                n_acc += 1
            tokens = n_acc + 1
            remaining = slot.sim.request.params.max_new_tokens - slot.generated
            tokens = min(tokens, max(remaining, 0))
            slot.generated += tokens
            slot.context += tokens
            emitted += tokens
            w.kv.extend_sequence(slot.sim.request.request_id, tokens)
            req = slot.sim.request
            req.output_tokens.extend([0] * tokens)
            req.token_times.extend([end] * tokens)
            if slot.generated >= req.params.max_new_tokens:
                finished.append(slot)
        if k > 0 and acc_samples:
            step_acc = float(np.mean([min(a, 1.0) for a in acc_samples]))
            w.acceptance = 0.8 * w.acceptance + 0.2 * step_acc

        for slot in finished:
            w.slots.remove(slot)
            req = slot.sim.request
            req.state = RequestState.FINISHED
            req.t_end = end
            w.kv.free_sequence(req.request_id)
            self.monitor.complete_request(
                RequestRecord(
                    request_id=req.request_id,
                    t_start=req.arrival_time,
                    t_end=end,
                    prompt_len=req.prompt_len,
                    generated=slot.generated,
                    token_times=list(req.token_times),
                    worker_id=wid,
                )
            )

        if mono:
            w.lane_busy_until = end
        else:
            w.decode_busy_until = end
        self.monitor.record_tokens(wid, emitted, end)
        w.publish(end)
        self.trace.append(
            {"t": end, "wid": wid, "depth": k, "batch": B,
             "emitted": emitted, "acc": w.acceptance, "iter_s": t_iter}
        )
        self.now = max(self.now, start)
        self._maybe_start_prefill(wid)
        if w.slots:
            w.decode_scheduled = True
            self._push(end, self.DECODE_TICK, (wid,))

    def _on_fail(self, wid):
        """Node failure: drop the pair; active + queued requests re-route."""
        w = self.workers[wid]
        w.healthy = False
        # active sequences are lost mid-decode -> resubmit from scratch
        orphans = [s.sim for s in w.slots]
        w.slots.clear()
        self.scheduler.mark_unhealthy(wid, self.now)
        for sim in orphans:
            req = sim.request
            w.kv.free_sequence(req.request_id)
            req.output_tokens.clear()
            req.token_times.clear()
            req.state = RequestState.QUEUED
            # last worker down: FAIL with a record instead of raising mid-loop
            if self.scheduler.resubmit_or_fail(req, self.now):
                self._maybe_start_prefill(req.worker_id)


# ---------------------------------------------------------------------------
# Canonical deployments (paper §4.1) on a 4-device node
# ---------------------------------------------------------------------------


def streamserve_config(**kw):
    kw.setdefault("max_batch", 32)
    return SimConfig(mode="streamserve", n_workers=2, lane_chips=1, **kw)


VLLM_ENGINE_OVERHEAD = 25e-3  # v0.4.x Python engine loop (see SimConfig)


def vllm_tp_config(speculative=False, fixed_depth=0, **kw):
    return SimConfig(
        mode="monolithic", n_workers=1, lane_chips=4, router="roundrobin",
        speculative=speculative, adaptive=False, fixed_depth=fixed_depth,
        max_batch=32, engine_overhead=VLLM_ENGINE_OVERHEAD, **kw,
    )


def vllm_dp_config(**kw):
    # one-device workers: weights + guaranteed KV reservation leave room
    # for only a small decode batch (the paper's DP baseline saturates first)
    return SimConfig(
        mode="monolithic", n_workers=4, lane_chips=1, router="roundrobin",
        speculative=False, max_batch=4, engine_overhead=VLLM_ENGINE_OVERHEAD, **kw,
    )
