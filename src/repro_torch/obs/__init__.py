"""Span assembly: phase-attributed latency of each request (host-side only).
StreamTrace event recording and its exporters are not ported yet (ROADMAP)."""
from repro_torch.obs.spans import compute_phases, request_phases  # noqa: F401
