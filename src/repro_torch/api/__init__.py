"""Public serving API of the port: one config object, pluggable policies,
online serving.

    from repro_torch.api import ServeConfig, StreamServe

    serve = StreamServe(ServeConfig(), device="cuda")
    handle = serve.submit(prompt_tokens)
    for token in handle.stream():
        ...
"""
from repro_torch.api.config import ServeConfig  # noqa: F401
from repro_torch.api.frontend import RequestFailedError, RequestHandle, StreamServe  # noqa: F401
from repro_torch.api.registry import (  # noqa: F401
    DRAFTS,
    ROUTERS,
    SPEC_POLICIES,
    register_draft,
    register_router,
    register_spec_policy,
    resolve_draft,
    resolve_router,
    resolve_spec_policy,
)
