"""Span assembly — phase-attributed latency from request timestamps/events.

``compute_phases`` turns one request's lifecycle timestamps into the
``queued / prefill / decode / stalls`` breakdown whose parts sum EXACTLY to
end-to-end latency (the identity tested in tests/test_obs.py):

* **queued**  — arrival until prefill service starts (includes requeue waits
  and, for shed/failed-before-service requests, the whole lifetime)
* **prefill** — ticks the prefill lane actively served this request.  The
  bucketed path admits in a single tick; the chunked path serves one chunk
  per granted lane turn, counted via ``Request.prefill_active_ticks``.
* **decode**  — first token until terminal
* **stalls**  — everything else: chunk-boundary preemption parks (EDF gave
  the lane to an earlier deadline) plus any residual between phases

All quantities are engine ticks (the injected clock) — deterministic, no
wall time.
"""
from __future__ import annotations


def compute_phases(
    arrival,
    t_prefill_start,
    t_prefill_end,
    t_first_token,
    t_end,
    prefill_active_ticks=0,
):
    """(queued, prefill, decode, stalls) summing exactly to t_end - arrival.

    Timestamp conventions: ``None`` == "never happened" — any numeric value,
    INCLUDING 0.0, is a real stamp (tick-0 service is legitimate; a falsy
    guard here used to misattribute it).  The bucketed/paged admit path
    stamps start == end == first_token at the admission tick; the chunked
    path stamps start at the first chunk and end/first_token at completion,
    with ``prefill_active_ticks`` counting the lane turns actually granted
    (the first granted turn lands on the start tick itself, so active
    service spans ``active - 1`` ticks past start — the rest of the
    start->end window is preemption stall).

    Legacy callers that still pass the old 0.0-as-never sentinels keep the
    sum identity: a 0.0 stamp clamps into ``[arrival, t_end]`` like any
    other early stamp.
    """
    t0 = arrival if arrival is not None else 0.0
    if t_end is None:        # not terminal yet: nothing to attribute
        return 0.0, 0.0, 0.0, 0.0
    latency = max(t_end - t0, 0.0)
    if t_prefill_start is None:
        # never reached the prefill lane (shed / failed / cancelled queued)
        return latency, 0.0, 0.0, 0.0
    # clamp stamps into [arrival, end]: tests and replay traces may carry a
    # pre-stamped FUTURE arrival_time (the request was submitted before its
    # nominal arrival tick), and latency is defined against that arrival —
    # service before t0 attributes as zero, keeping the sum identity exact
    ps = min(max(t_prefill_start, t0), t_end)
    pe = min(max(t_prefill_end, t0), t_end) if t_prefill_end is not None else None
    ft = min(max(t_first_token, t0), t_end) if t_first_token is not None else None
    t_prefill_start, t_prefill_end, t_first_token = ps, pe, ft
    queued = max(t_prefill_start - t0, 0.0)
    window_end = t_prefill_end if t_prefill_end is not None else t_end
    window = max(window_end - t_prefill_start, 0.0)
    if prefill_active_ticks > 0:
        prefill = min(float(prefill_active_ticks - 1), window)
    else:
        prefill = window  # one-shot admission: the whole window is service
    decode = max(t_end - t_first_token, 0.0) if t_first_token is not None else 0.0
    # exact residual keeps the sum identity; clamped at 0 defensively (the
    # engine's stamp ordering guarantees non-negative residuals)
    stalls = max(latency - queued - prefill - decode, 0.0)
    prefill = max(latency - queued - decode - stalls, 0.0)
    return queued, prefill, decode, stalls


def request_phases(req):
    """Phase breakdown straight off a terminal :class:`Request`."""
    return compute_phases(
        req.arrival_time,
        req.t_prefill_start,
        req.t_prefill_end,
        req.t_first_token,
        req.t_end,
        getattr(req, "prefill_active_ticks", 0),
    )
