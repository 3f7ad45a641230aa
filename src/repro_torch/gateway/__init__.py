"""Async HTTP gateway: the network front door for :class:`StreamServe`.

    from repro_torch.api import ServeConfig, StreamServe
    from repro_torch.gateway import run_gateway

    serve = StreamServe(ServeConfig.reduced_smoke(), device="cpu")
    run_gateway(serve, port=8080)        # blocking; Ctrl-C to stop

or ``python -m repro_torch.launch.serve --device cpu --http --port 8080``.
:mod:`repro_torch.gateway.server` holds the endpoints and the engine's
stepping task, :mod:`repro_torch.gateway.http` the stdlib HTTP/SSE layer and
:mod:`repro_torch.gateway.client` stdlib clients.
"""
from repro_torch.gateway.server import Gateway, GatewayThread, run_gateway  # noqa: F401
