"""Trace exporters — Chrome-trace/Perfetto JSON and Prometheus text format
(a copy of ``repro.obs.export``).

This is the only layer where wall-clock units exist: tick timestamps are
scaled by ``tick_us`` microseconds per tick for the Chrome viewer.

* :func:`chrome_trace` — one process per stream pair, threads for the
  prefill / decode / verify lanes, counter tracks for queue depth, free
  pages, acceptance EMA and mean speculation depth.  Load the output in
  ``chrome://tracing`` or https://ui.perfetto.dev.
* :class:`PromRegistry` — a small text-exposition registry (counters,
  gauges, histograms) that the HTTP gateway's ``/metrics`` serves;
  :func:`engine_registry` fills it from a live engine.
"""
from __future__ import annotations

import json

from repro_torch.obs.trace import EV_ADMIT, EV_COUNTERS, EV_DECODE_STEP, EV_PREFILL_START, EV_VERIFY

TICK_US = 1000.0  # Chrome-trace microseconds per engine tick


def _ts(tick, tick_us):
    return max(tick - 1.0, 0.0) * tick_us  # ticks start at 1.0


def chrome_trace(events, tick_us=TICK_US):
    """Chrome-trace JSON ("traceEvents" format) from a raw event stream.

    Spans: per-request prefill spans (prefill_start -> admit) on the
    "prefill" thread, per-tick decode and verify X events on their own
    threads.  Counters: queue depth, free pages, acceptance EMA, mean depth
    (from ``counters`` events).  One process per worker.
    """
    te = []
    workers = sorted({e[2] for e in events if e[2] >= 0})
    threads = (("prefill", 0), ("decode", 1), ("verify", 2))
    for w in workers:
        te.append({"ph": "M", "pid": w, "tid": 0, "name": "process_name",
                   "args": {"name": f"pair{w}"}})
        for tname, tid in threads:
            te.append({"ph": "M", "pid": w, "tid": tid, "name": "thread_name",
                       "args": {"name": tname}})
    prefill_open = {}
    for _seq, tick, worker, etype, rid, payload in events:
        if worker < 0:
            continue
        if etype == EV_PREFILL_START:
            prefill_open[rid] = (tick, worker, payload)
        elif etype == EV_ADMIT and rid in prefill_open:
            t0, w0, p0 = prefill_open.pop(rid)
            te.append({
                "ph": "X", "pid": w0, "tid": 0, "name": f"prefill {rid}",
                "ts": _ts(t0, tick_us),
                "dur": max(tick - t0, 1.0) * tick_us,
                "args": {"prompt_len": p0[0], "cache_hit_tokens": p0[1]},
            })
        elif etype == EV_DECODE_STEP:
            occupancy, k, k_pad, emitted = payload[0], payload[1], payload[2], payload[3]
            te.append({
                "ph": "X", "pid": worker, "tid": 1,
                "name": f"decode b={occupancy}",
                "ts": _ts(tick, tick_us), "dur": tick_us,
                "args": {"occupancy": occupancy, "k": k, "k_pad": k_pad,
                         "emitted": emitted},
            })
        elif etype == EV_VERIFY:
            te.append({
                "ph": "X", "pid": worker, "tid": 2,
                "name": f"verify k={payload[1]}",
                "ts": _ts(tick, tick_us), "dur": tick_us,
                "args": {"k": payload[0], "k_pad": payload[1]},
            })
        elif etype == EV_COUNTERS:
            qd, free_pages, _used, acceptance, load, mean_depth = payload
            ts = _ts(tick, tick_us)
            for name, value in (
                ("queue_depth", qd), ("kv_free_pages", free_pages),
                ("acceptance_ema", acceptance), ("mean_depth", mean_depth),
                ("active_load", load),
            ):
                te.append({"ph": "C", "pid": worker, "tid": 0, "name": name,
                           "ts": ts, "args": {name: value}})
    return {"traceEvents": te, "displayTimeUnit": "ms",
            "otherData": {"tick_us": tick_us}}


def save_chrome_trace(events, path, tick_us=TICK_US):
    doc = chrome_trace(events, tick_us=tick_us)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


# ---------------------------------------------------------------- Prometheus
TICK_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
TPOT_BUCKETS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)


def _fmt_labels(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_val(v):
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    def __init__(self, name, mtype, help_):
        self.name = name
        self.mtype = mtype
        self.help = help_
        # label tuple -> value (counter/gauge) or histogram state
        self.samples = {}


class PromRegistry:
    """Minimal Prometheus text-exposition registry (v0.0.4 format).

    Deterministic output: metrics render in registration order, samples in
    sorted-label order — two identical engine states produce byte-identical
    expositions.
    """

    def __init__(self):
        self._metrics = {}

    def _get(self, name, mtype, help_):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = _Metric(name, mtype, help_)
        elif m.mtype != mtype:
            raise ValueError(f"metric {name} re-registered as {mtype} (was {m.mtype})")
        return m

    @staticmethod
    def _key(labels):
        if not labels:
            return ()
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def counter(self, name, help_, value=0.0, labels=None):
        m = self._get(name, "counter", help_)
        key = self._key(labels)
        m.samples[key] = m.samples.get(key, 0.0) + value

    def gauge(self, name, help_, value, labels=None):
        m = self._get(name, "gauge", help_)
        m.samples[self._key(labels)] = value

    def histogram(self, name, help_, values, buckets=TICK_BUCKETS, labels=None):
        m = self._get(name, "histogram", help_)
        key = self._key(labels)
        state = m.samples.get(key)
        if state is None:
            state = m.samples[key] = {
                "buckets": tuple(buckets), "counts": [0] * len(buckets),
                "sum": 0.0, "count": 0,
            }
        for v in values:
            for i, le in enumerate(state["buckets"]):
                if v <= le:
                    state["counts"][i] += 1
            state["sum"] += v
            state["count"] += 1

    def render(self):
        lines = []
        for m in self._metrics.values():  # insertion order: deterministic
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.mtype}")
            for key in sorted(m.samples):
                if m.mtype == "histogram":
                    st = m.samples[key]
                    for le, c in zip(st["buckets"], st["counts"], strict=True):
                        lk = key + (("le", _fmt_val(le)),)
                        lines.append(f"{m.name}_bucket{_fmt_labels(lk)} {c}")
                    lk = key + (("le", "+Inf"),)
                    lines.append(f"{m.name}_bucket{_fmt_labels(lk)} {st['count']}")
                    lines.append(f"{m.name}_sum{_fmt_labels(key)} {_fmt_val(st['sum'])}")
                    lines.append(f"{m.name}_count{_fmt_labels(key)} {st['count']}")
                else:
                    lines.append(
                        f"{m.name}{_fmt_labels(key)} {_fmt_val(m.samples[key])}"
                    )
        return "\n".join(lines) + "\n"


def engine_registry(engine):
    """Populate a :class:`PromRegistry` from a live ``PipeServeEngine``.

    Duck-typed over the engine surface (monitor, scheduler, pairs).
    """
    reg = PromRegistry()
    recs = engine.monitor.completed
    served = [r for r in recs if not r.cancelled and not r.slo_infeasible]
    for state, pred in (
        ("finished", lambda r: not r.cancelled and not r.slo_infeasible),
        ("cancelled", lambda r: r.cancelled),
        ("shed", lambda r: r.slo_infeasible),
    ):
        reg.counter("streamserve_requests_total", "Terminal requests by state",
                    sum(1 for r in recs if pred(r)), labels={"state": state})
    reg.counter("streamserve_tokens_generated_total", "Generated tokens",
                sum(r.generated for r in recs))
    reg.counter("streamserve_kv_requeues_total",
                "Mid-decode evict-and-requeue events",
                sum(r.kv_requeued for r in recs))
    reg.histogram("streamserve_ttft_ticks", "Time to first token (engine ticks)",
                  [r.ttft for r in served if r.token_times], TICK_BUCKETS)
    reg.histogram("streamserve_tpot_ticks", "Mean inter-token time (engine ticks)",
                  [r.tpot for r in served if r.tpot > 0], TPOT_BUCKETS)
    reg.histogram("streamserve_latency_ticks", "End-to-end latency (engine ticks)",
                  [r.latency for r in served], TICK_BUCKETS)
    for phase in ("queued", "prefill", "decode", "stall"):
        reg.histogram(
            f"streamserve_phase_{phase}_ticks",
            f"Per-request {phase} phase (engine ticks)",
            [getattr(r, f"phase_{phase}") for r in served], TICK_BUCKETS,
        )
    for pair in engine.pairs:
        w = {"worker": pair.worker_id}
        reg.gauge("streamserve_worker_healthy", "1 when the pair serves traffic",
                  1 if pair.healthy else 0, labels=w)
        reg.gauge("streamserve_queue_depth", "Queued + parked prefill work",
                  engine.scheduler.queue_depth(pair.worker_id), labels=w)
        reg.gauge("streamserve_active_load", "Occupied decode-slot fraction",
                  round(pair.load, 6), labels=w)
        reg.gauge("streamserve_acceptance_ema", "Speculative acceptance EMA",
                  round(pair.acceptance, 6), labels=w)
        reg.gauge("streamserve_kv_used_pages", "Allocated KV pool blocks",
                  pair.kv.used, labels=w)
        reg.gauge("streamserve_kv_free_pages", "Free KV pool blocks",
                  pair.kv.free_blocks, labels=w)
        reg.counter("streamserve_kv_resurrections_total",
                    "Cached freed pages revived by a prefix re-hit",
                    pair.kv.resurrections, labels=w)
        reg.counter("streamserve_kv_lazy_evictions_total",
                    "Cached freed prefixes recycled off the FIFO free list",
                    pair.kv.lazy_evictions, labels=w)
        reg.gauge("streamserve_spec_depth", "Last adaptive depth decision",
                  pair.spec.snapshot()[1], labels=w)
    return reg
