"""StreamTrace — structured event tracing for the serving stack (a copy of
``repro.obs.trace``).

The recorder is a preallocated per-worker ring of typed tuple events.  Every
payload field is host state the engine already holds after its one bulk
device->host copy a step, so recording adds no copy and no synchronisation,
and timestamps are engine ticks: wall time enters only in the exporters.

Event tuples are ``(seq, tick, worker, etype, request_id, payload)``:

* ``seq``     — global monotonic sequence number (total order across workers)
* ``tick``    — engine clock at emission (1.0 per ``step()``)
* ``worker``  — stream-pair id, or -1 for control-plane (scheduler) events
* ``etype``   — int code from the ``EV_*`` constants (``EVENT_NAMES[etype]``)
* ``request_id`` — the subject request, or None for worker-scoped events
* ``payload`` — a flat tuple whose schema is fixed per event type
  (``EVENT_SCHEMAS``)

``TraceRecorder`` keeps the last ``capacity`` events per worker, so a
flight-recorder dump holds each worker's recent history however lopsided the
traffic.  ``NullRecorder`` is the default: call sites guard payload
construction with ``if trace.enabled``.
"""
from __future__ import annotations

EV_SUBMIT = 0           # (prompt_len, slo_ttft, slo_tpot)
EV_ROUTE = 1            # (worker, ((worker, *score_terms), ...))
EV_ENQUEUE = 2          # (queue_len_after,)
EV_EDF_POP = 3          # (popped_index, deadline)
EV_SHED = 4             # (deadline,)
EV_PREFILL_START = 5    # (prompt_len, cache_hit_tokens)
EV_PREFILL_CHUNK = 6    # (cursor_after, n_tokens)
EV_PREFILL_PREEMPT = 7  # (cursor, winner_request_id)
EV_PREFILL_RESUME = 8   # (cursor,)
EV_PREFILL_END = 9      # (fused_batch,)
EV_ADMIT = 10           # (slot,)
EV_DECODE_STEP = 11     # (occupancy, k, k_pad, emitted, acceptance, depths, accepted)
EV_VERIFY = 12          # (k, k_pad)
EV_KV_ALLOC = 13        # (n_blocks, shared_blocks, hit_tokens)
EV_KV_EVICT = 14        # (slot, freed_blocks)
EV_KV_REQUEUE = 15      # (kv_requeued,)
EV_FINISH = 16          # (generated, kv_evicted, queued, prefill, decode, stalls)
EV_CANCEL = 17          # (generated, queued, prefill, decode, stalls)
EV_FAIL = 18            # (reason, queued, prefill, decode, stalls)
EV_COUNTERS = 19        # (queue_depth, free_pages, used_pages, acceptance, load, mean_depth)
EV_METRICS_STALE = 20   # (age_ticks,)
EV_WORKER_FAIL = 21     # (rerouted,)

EVENT_NAMES = (
    "submit", "route", "enqueue", "edf_pop", "shed",
    "prefill_start", "prefill_chunk", "prefill_preempt", "prefill_resume",
    "prefill_end", "admit", "decode_step", "verify",
    "kv_alloc", "kv_evict", "kv_requeue",
    "finish", "cancel", "fail",
    "counters", "metrics_stale", "worker_fail",
)

# payload field names per event type (documentation, traceview rendering)
EVENT_SCHEMAS = {
    "submit": ("prompt_len", "slo_ttft", "slo_tpot"),
    "route": ("worker", "score_breakdown"),
    "enqueue": ("queue_len",),
    "edf_pop": ("popped_index", "deadline"),
    "shed": ("deadline",),
    "prefill_start": ("prompt_len", "cache_hit_tokens"),
    "prefill_chunk": ("cursor", "n_tokens"),
    "prefill_preempt": ("cursor", "winner"),
    "prefill_resume": ("cursor",),
    "prefill_end": ("fused_batch",),
    "admit": ("slot",),
    "decode_step": ("occupancy", "k", "k_pad", "emitted", "acceptance", "depths", "accepted"),
    "verify": ("k", "k_pad"),
    "kv_alloc": ("n_blocks", "shared_blocks", "hit_tokens"),
    "kv_evict": ("slot", "freed_blocks"),
    "kv_requeue": ("kv_requeued",),
    "finish": ("generated", "kv_evicted", "queued", "prefill", "decode", "stalls"),
    "cancel": ("generated", "queued", "prefill", "decode", "stalls"),
    "fail": ("reason", "queued", "prefill", "decode", "stalls"),
    "counters": ("queue_depth", "free_pages", "used_pages", "acceptance", "load", "mean_depth"),
    "metrics_stale": ("age_ticks",),
    "worker_fail": ("rerouted",),
}

SCHEMA_VERSION = "streamtrace/v1"

# terminal event codes: traceview and the span assembler key off these
TERMINAL_EVENTS = (EV_FINISH, EV_CANCEL, EV_FAIL)


class NullRecorder:
    """The stand-in when tracing is off (the default): ``enabled`` is False,
    so call sites skip payload construction; ``emit`` is still callable."""

    enabled = False
    dropped = 0

    def emit(self, tick, worker, etype, request_id=None, payload=()):
        pass

    def events(self):
        return []

    def to_dump(self, reason="", tick=0.0):
        return {"schema": SCHEMA_VERSION, "reason": reason, "tick": tick,
                "dropped": 0, "events": []}


class TraceRecorder:
    """Preallocated per-worker ring buffer of typed tuple events.

    Each worker id (lazily) owns a fixed ``capacity``-long list used as a
    circular buffer; a global ``seq`` counter orders cross-worker merges.
    """

    enabled = True

    def __init__(self, capacity=4096):
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1 (got {capacity})")
        self.capacity = capacity
        self._rings = {}
        self._cursor = {}
        self._seq = 0
        self.dropped = 0  # events overwritten by ring wraparound

    def emit(self, tick, worker, etype, request_id=None, payload=()):
        ring = self._rings.get(worker)
        if ring is None:
            ring = self._rings[worker] = [None] * self.capacity
            self._cursor[worker] = 0
        i = self._cursor[worker]
        if ring[i] is not None:
            self.dropped += 1
        ring[i] = (self._seq, tick, worker, etype, request_id, payload)
        self._cursor[worker] = (i + 1) % self.capacity
        self._seq += 1

    def __len__(self):
        return sum(sum(e is not None for e in ring) for ring in self._rings.values())

    def events(self):
        """All retained events merged across workers, in emission order."""
        out = [e for ring in self._rings.values() for e in ring if e is not None]
        out.sort(key=lambda e: e[0])
        return out

    def events_for(self, request_id):
        return [e for e in self.events() if e[4] == request_id]

    def clear(self):
        self._rings.clear()
        self._cursor.clear()
        self.dropped = 0

    def to_dump(self, reason="", tick=0.0):
        """JSON-serialisable flight-recorder dump (tick timestamps only)."""
        return {
            "schema": SCHEMA_VERSION, "reason": reason, "tick": tick, "dropped": self.dropped,
            "columns": ["seq", "tick", "worker", "type", "request", "data"],
            "events": [[seq, tick_, worker, EVENT_NAMES[etype], rid, list(payload)]
                       for seq, tick_, worker, etype, rid, payload in self.events()],
        }


def make_recorder(mode, capacity=4096):
    """Recorder for the ``trace`` config knob."""
    if mode == "off":
        return NullRecorder()
    if mode in ("on", "flight"):
        return TraceRecorder(capacity)
    raise ValueError(f"trace must be 'off', 'on' or 'flight' (got {mode!r})")
