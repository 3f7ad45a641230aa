"""StreamTrace observability: structured tracing, span assembly, exporters.

Host-side only and engine-agnostic (the engine imports it, not the other way
round): recorders and span math run over values the engine already fetched.
"""
from repro_torch.obs.export import (  # noqa: F401
    PromRegistry,
    chrome_trace,
    engine_registry,
    save_chrome_trace,
)
from repro_torch.obs.spans import compute_phases, request_phases, worker_timelines  # noqa: F401
from repro_torch.obs.trace import (  # noqa: F401
    EVENT_NAMES,
    EVENT_SCHEMAS,
    SCHEMA_VERSION,
    NullRecorder,
    TraceRecorder,
    make_recorder,
)
