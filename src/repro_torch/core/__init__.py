"""StreamScheduler, FlowGuard, PipeServe-Engine and SpecuStream on PyTorch."""
from repro_torch.core.engine import EngineConfig, PipeServeEngine, StreamPair  # noqa: F401
from repro_torch.core.flowguard import FlowGuard, FlowGuardConfig  # noqa: F401
from repro_torch.core.metrics import PerformanceMonitor, RequestRecord, WorkerMetrics  # noqa: F401
from repro_torch.core.scheduler import StreamScheduler  # noqa: F401
from repro_torch.core.specustream import SpecuStream, SpecuStreamConfig  # noqa: F401
