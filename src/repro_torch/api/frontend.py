"""`StreamServe` — the online serving front-end over `PipeServeEngine`
(a port of ``repro.api.frontend``).

Requests are submitted at any time, each submission returns a
:class:`RequestHandle`, and handles expose per-token streaming, blocking
results, cancellation and SLO metadata.  The loop is ``step()``-driven and
single-threaded: pulling on any handle's ``stream()`` advances the whole
engine, so concurrent handles make progress together:

    serve = StreamServe(ServeConfig.reduced_smoke(), device="cpu")
    h = serve.submit(prompt_tokens)
    for tok in h.stream():          # yields tokens as the engine emits them
        ...
    print(h.slo())                  # ttft / tpot / latency (engine ticks)
"""
from __future__ import annotations


from repro_torch.api.config import ServeConfig
from repro_torch.serving.request import Request, RequestState, SamplingParams

_TERMINAL = (RequestState.FINISHED, RequestState.FAILED, RequestState.CANCELLED)


class RequestFailedError(RuntimeError):
    """A request terminated ``FAILED`` (shed, ``no_healthy_workers``...);
    carries the engine's ``error`` string and the tokens emitted before."""

    def __init__(self, request_id, error, partial_tokens):
        self.request_id = request_id
        self.error = error or "failed"
        self.partial_tokens = list(partial_tokens)
        super().__init__(f"{request_id} failed: {self.error} "
                         f"({len(self.partial_tokens)} tokens emitted before failure)")


class RequestHandle:
    """Live view of one submitted request: ``stream()`` yields tokens as the
    engine emits them (driving it one tick at a time), ``result()`` drains
    the stream, ``cancel()`` aborts the request wherever it is."""

    def __init__(self, serve, request):
        self._serve = serve
        self.request = request
        self._cursor = 0

    @property
    def slo_ttft(self):
        return self.request.slo_ttft

    @property
    def slo_tpot(self):
        return self.request.slo_tpot

    @property
    def request_id(self):
        return self.request.request_id

    @property
    def state(self):
        return self.request.state

    @property
    def done(self):
        return self.request.state in _TERMINAL

    @property
    def cancelled(self):
        return self.request.state is RequestState.CANCELLED

    def stream(self, max_stall_steps=10_000):
        """Yield output tokens as they are emitted, driving the engine.
        Raises :class:`RequestFailedError` once the request fails."""
        stalled = 0
        while True:
            out = self.request.output_tokens
            if self._cursor < len(out):
                stalled = 0
                self._cursor += 1
                yield out[self._cursor - 1]
                continue
            if self.done:
                if self.request.state is RequestState.FAILED:
                    raise RequestFailedError(self.request_id, self.request.error, out)
                return
            self._serve.step()
            stalled += 1
            if stalled > max_stall_steps:
                raise RuntimeError(f"{self.request_id} made no progress in "
                                   f"{max_stall_steps} engine steps")

    def result(self, max_stall_steps=10_000):
        """Drive the engine until the request ends; return all its tokens."""
        for _ in self.stream(max_stall_steps=max_stall_steps):
            pass
        return list(self.request.output_tokens)

    def cancel(self):
        return self._serve.cancel(self.request_id)

    def slo(self):
        """Latency metadata in engine ticks."""
        req = self.request
        arrived = req.arrival_time if req.arrival_time is not None else 0.0
        # `is not None`, never truthiness: tick 0 is a real measurement
        ttft = req.t_first_token - arrived if req.t_first_token is not None else None
        latency = req.t_end - arrived if self.done and req.t_end is not None else None
        tpot = req.measured_tpot()
        return {
            "request_id": req.request_id, "state": req.state.value,
            "worker_id": req.worker_id, "arrival_time": req.arrival_time,
            "n_tokens": len(req.output_tokens), "ttft": ttft, "tpot": tpot,
            "latency": latency, "cancelled": self.cancelled,
            "slo_infeasible": req.error == "slo_infeasible",
            "mean_depth": (sum(req.spec_depths) / len(req.spec_depths)
                           if req.spec_depths else None),
            "ttft_ok": None if ttft is None or req.slo_ttft is None else ttft <= req.slo_ttft,
            "tpot_ok": None if tpot is None or req.slo_tpot is None else tpot <= req.slo_tpot,
        }


class StreamServe:
    """Single public entry point to the serving stack.

    Builds the model (or takes ``params`` in the port's layout, e.g. from
    :func:`repro_torch.params.from_jax_tree`) and, for ``draft="model"``,
    the draft model (its seeded init at ``seed + 1``, or ``draft_params``),
    resolves all policies through the registries, and wraps
    :class:`PipeServeEngine` with an online submit/stream/cancel surface.
    ``device=None`` runs on the card and raises where there is none; tests
    pass ``device="cpu"``.
    """

    def __init__(self, config=None, *, params=None, draft_params=None,
                 arch_cfg=None, device=None, **overrides):
        from repro_torch.core.engine import PipeServeEngine, check_servable, resolve_device
        from repro_torch.models import build_model

        config = config or ServeConfig()
        self.config = config = config.replace(**overrides) if overrides else config
        self.device = resolve_device(device)
        self.arch = arch_cfg if arch_cfg is not None else config.build_arch_config()
        check_servable(self.arch)  # before any weights are made
        if params is None:  # no checkpoint: seeded random weights on the device
            params = build_model(self.arch, self.device).init(config.seed)
        draft_cfg = None
        if config.draft == "model":
            draft_cfg = config.build_draft_arch_config()
            if draft_params is None:
                draft_params = build_model(draft_cfg, self.device).init(config.seed + 1)
        self.engine = PipeServeEngine(self.arch, params, n_pairs=config.n_pairs,
                                      econf=config.build_engine_config(), draft_cfg=draft_cfg,
                                      draft_params=draft_params, device=self.device)

    def submit(self, prompt, params=None, *,
               slo_ttft=None,
               slo_tpot=None):
        """Submit a tokenised prompt; returns immediately with a handle
        (callable at any time, including while others are mid-decode)."""
        prompt = list(prompt)
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if params is None:
            params = SamplingParams(temperature=self.config.temperature,
                                    max_new_tokens=self.config.max_new_tokens)
        # paged mode: pages, not per-slot rows, bound the context
        cfg = self.config
        ceiling = cfg.max_context if cfg.paged_kv and cfg.max_context else cfg.max_len
        if len(prompt) + params.max_new_tokens > ceiling:
            what = "max_context" if ceiling != cfg.max_len else "max_len"
            raise ValueError(f"prompt ({len(prompt)}) + max_new_tokens ({params.max_new_tokens}) "
                             f"exceeds {what} ({ceiling})")
        req = Request(prompt=prompt, params=params, slo_ttft=slo_ttft, slo_tpot=slo_tpot)
        self.engine.submit(req)
        return RequestHandle(self, req)

    def cancel(self, request_id):
        return self.engine.cancel(request_id)

    def step(self):
        """Advance the engine one tick; returns tokens emitted this tick."""
        return self.engine.step()

    def run_until_done(self, max_steps=10_000):
        self.engine.run_until_done(max_steps=max_steps)

    @property
    def pending(self):
        """Requests queued, mid-chunked-prefill or mid-decode across healthy pairs."""
        return self.engine.scheduler.pending_total() + sum(
            len(p.active_slots()) + p.prefill_in_flight() for p in self.engine.pairs if p.healthy)

    def fail_worker(self, worker_id):
        return self.engine.fail_worker(worker_id)

    def trace_events(self):
        """Raw StreamTrace events (empty when ``trace='off'``)."""
        return self.engine.trace_events()

    def export_chrome_trace(self, path=None):
        """Chrome-trace/Perfetto JSON of the retained trace events."""
        return self.engine.export_chrome_trace(path)

    def prometheus_text(self):
        """Prometheus text exposition of the engine's state (what the
        gateway's ``/metrics`` serves)."""
        return self.engine.prometheus_text()

    @property
    def flight_dumps(self):
        """Flight-recorder dumps so far (engine exception or ``fail_worker``),
        newest last."""
        return self.engine.flight_dumps

    @property
    def monitor(self):
        return self.engine.monitor

    def summary(self):
        return self.engine.monitor.summary()

    def worker_stats(self):
        """Per-pair operational snapshot (routing and speculation signals).
        A pair missing from the monitor degrades to a ``healthy: False`` row
        instead of raising mid-scrape."""
        out = []
        for pair in self.engine.pairs:
            m = self.engine.monitor.workers.get(pair.worker_id)
            if m is None:
                out.append({"worker_id": pair.worker_id, "healthy": False, "acceptance": 0.0,
                            "cache_hit_rate": 0.0, "queue_depth": 0, "active_load": 0.0,
                            "spec_depth": None, "slot_depths": [None] * len(pair.slot_req)})
                continue
            d = pair.spec.last_decision
            out.append({
                "worker_id": pair.worker_id, "healthy": pair.healthy,
                "acceptance": pair.acceptance, "cache_hit_rate": m.cache_hit_rate,
                "queue_depth": m.queue_depth, "active_load": pair.load,
                "spec_depth": d.bucket_depth if d else None,
                # each occupied slot's latest depth (the per-row control plane)
                "slot_depths": [r.spec_depths[-1] if r is not None and r.spec_depths else None
                                for r in pair.slot_req],
            })
        return out
