"""The StreamServe HTTP gateway: OpenAI-compatible completions over SSE (a
port of ``repro.gateway.server`` over the port's ``StreamServe``).

The engine stays single-threaded: every engine interaction (``submit``,
``step``, ``cancel``, ``fail_worker``, metric scrapes) happens on ONE asyncio
event loop.  A stepping task owns the step loop and, after every tick, pumps
each live request's new tokens into its ``asyncio.Queue``; handlers touch the
engine only between steps, so no locks are needed.  On the card the steps
replay CUDA graphs: capture them all (``engine.warmup()``) before ``start()``
and make no CUDA call from another thread while the gateway serves.

Endpoints:

* ``POST /v1/completions`` — ``prompt`` (token-id list, or a string
  byte-tokenised here), ``max_tokens``, ``stream``, optional ``slo_ttft`` /
  ``slo_tpot``.  Streaming replies are SSE ``data:`` frames (one token a
  frame, a terminal frame with ``finish_reason``/``usage``, then
  ``data: [DONE]``); otherwise one JSON body at the end.
* ``POST /v1/cancel/<request_id>`` — cancel wherever the request is.
* ``GET  /healthz`` — liveness and pair health.
* ``GET  /metrics`` — the engine's Prometheus text exposition.
* ``POST /admin/fail_worker/<id>`` — kill a stream pair (chaos drills).

Submissions past ``ServeConfig.gateway_max_pending`` in-flight requests get
``429 Too Many Requests`` with ``Retry-After``.  A client that disconnects
mid-stream has its request cancelled, freeing its slot and KV.
"""
from __future__ import annotations

import asyncio
import dataclasses
import threading
from typing import Any

from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.gateway.http import AsyncHTTPServer, HTTPResponse, SSEResponse
from repro_torch.serving.request import SamplingParams

_END = object()          # ticket-queue sentinel: request reached terminal

# engine failure reason -> HTTP status for non-streaming replies
_FAIL_STATUS = {
    "slo_infeasible": 503,
    "no_healthy_workers": 503,
    "exceeds_max_context": 400,
}


@dataclasses.dataclass
class _Ticket:
    """Delivery state for one live request: handle cursor -> asyncio queue."""
    handle: Any                       # RequestHandle
    queue: asyncio.Queue
    cursor: int = 0
    text_mode: bool = False           # prompt arrived as a string


class Gateway:
    """Asyncio HTTP gateway over one :class:`repro_torch.api.StreamServe`."""

    def __init__(self, serve, host=None, port=None, max_pending=None):
        cfg = serve.config
        self.serve = serve
        self.max_pending = (max_pending if max_pending is not None
                            else cfg.gateway_max_pending)
        self._tickets = {}
        self._wake = None    # an asyncio.Event, created on the loop
        self._stepper = None
        self._server = AsyncHTTPServer(
            self._route,
            host if host is not None else cfg.gateway_host,
            port if port is not None else cfg.gateway_port,
        )
        self._tokenizer = ByteTokenizer()  # for string prompts
        self.rejected_429 = 0

    # ------------------------------------------------------------- lifecycle
    @property
    def host(self):
        return self._server.host

    @property
    def port(self):
        return self._server.port

    async def start(self):
        """Bind the listener and start the engine's stepping task."""
        self._wake = asyncio.Event()
        port = await self._server.start()
        self._stepper = asyncio.get_running_loop().create_task(self._drive())
        return self._server.host, port

    async def stop(self):
        if self._stepper is not None:
            self._stepper.cancel()
            try:
                await self._stepper
            except asyncio.CancelledError:
                pass
            self._stepper = None
        await self._server.stop()

    # ------------------------------------------------------------ stepping task
    async def _drive(self):
        """The one owner of ``engine.step()``.

        Steps while work is in flight, yielding to the event loop between
        ticks so socket IO interleaves with compute; parks on an event when
        drained (a submission sets it)."""
        while True:
            if self.serve.pending > 0 or self._tickets:
                self.serve.step()
                self._pump()
                await asyncio.sleep(0)       # let IO run between ticks
            else:
                self._wake.clear()
                await self._wake.wait()

    def _pump(self):
        """Move newly emitted tokens into per-request queues; terminal
        requests get the END sentinel exactly once (their ticket is dropped
        in the same pass, so no double delivery is possible)."""
        finished = []
        for rid, t in self._tickets.items():
            out = t.handle.request.output_tokens
            while t.cursor < len(out):
                t.queue.put_nowait(out[t.cursor])
                t.cursor += 1
            if t.handle.done:
                t.queue.put_nowait(_END)
                finished.append(rid)
        for rid in finished:
            del self._tickets[rid]

    # ---------------------------------------------------------------- routing
    async def _route(self, req):
        path, post = req.path, req.method == "POST"
        if path == "/v1/completions":
            return await self._completions(req) if post else HTTPResponse.error(405, "use POST")
        if path.startswith("/v1/cancel/"):
            return (self._cancel_endpoint(path[len("/v1/cancel/"):]) if post
                    else HTTPResponse.error(405, "use POST"))
        if path == "/healthz":
            return self._healthz()
        if path == "/metrics":
            return HTTPResponse.text(self.serve.prometheus_text(),
                                     content_type="text/plain; version=0.0.4; charset=utf-8")
        if path.startswith("/admin/fail_worker/"):
            return (self._fail_worker(path[len("/admin/fail_worker/"):]) if post
                    else HTTPResponse.error(405, "use POST"))
        return HTTPResponse.error(404, f"no route for {path}")

    # ------------------------------------------------------------ completions
    async def _completions(self, req):
        body = req.json()
        if not isinstance(body, dict):
            return HTTPResponse.error(400, "body must be a JSON object")
        prompt = body.get("prompt")
        text_mode = isinstance(prompt, str)
        if text_mode:
            prompt = self._encode(prompt)
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            return HTTPResponse.error(
                400, "prompt must be a non-empty token-id list or a string"
            )
        # backpressure BEFORE touching the engine: shedding at the door is
        # the knob that keeps queueing (and TTFT) bounded under overload
        if self.serve.pending >= self.max_pending:
            self.rejected_429 += 1
            return HTTPResponse.error(
                429, f"server at capacity ({self.max_pending} pending)",
                code="overloaded", headers={"Retry-After": "1"},
            )
        params = SamplingParams(
            temperature=float(body.get("temperature",
                                       self.serve.config.temperature)),
            max_new_tokens=int(body.get("max_tokens",
                                        self.serve.config.max_new_tokens)),
        )
        slo_ttft = body.get("slo_ttft")
        slo_tpot = body.get("slo_tpot")
        try:
            handle = self.serve.submit(prompt, params,
                                       slo_ttft=slo_ttft, slo_tpot=slo_tpot)
        except ValueError as e:
            return HTTPResponse.error(400, str(e))
        rid = handle.request_id
        ticket = _Ticket(handle=handle, queue=asyncio.Queue(),
                         text_mode=text_mode)
        self._tickets[rid] = ticket
        self._wake.set()
        if body.get("stream"):
            return SSEResponse(
                self._sse_frames(rid, ticket),
                on_disconnect=lambda: self._client_dropped(rid),
            )
        return await self._blocking_reply(rid, ticket)

    async def _sse_frames(self, rid, ticket):
        """One SSE frame per token, one terminal frame, then ``[DONE]``."""
        while True:
            item = await ticket.queue.get()
            if item is _END:
                break
            yield {"id": rid, "object": "text_completion.chunk",
                   "choices": [{"index": 0, "token": item,
                                "text": self._decode([item], ticket)}]}
        req = ticket.handle.request
        if req.state.value == "failed":
            yield {"id": rid,
                   "error": {"message": f"request failed: {req.error}",
                             "code": req.error,
                             "partial_tokens": len(req.output_tokens)}}
        else:
            yield self._terminal_payload(rid, ticket)
        yield "[DONE]"

    async def _blocking_reply(self, rid, ticket):
        """Non-streaming: drain the ticket queue to terminal, answer once."""
        while True:
            item = await ticket.queue.get()
            if item is _END:
                break
        req = ticket.handle.request
        if req.state.value == "failed":
            return HTTPResponse.error(
                _FAIL_STATUS.get(req.error, 500),
                f"request failed: {req.error}", code=req.error,
                request_id=rid, partial_token_ids=list(req.output_tokens),
            )
        return HTTPResponse.json(self._terminal_payload(rid, ticket))

    def _terminal_payload(self, rid, ticket):
        handle, req = ticket.handle, ticket.handle.request
        if handle.cancelled:
            finish = "cancelled"
        elif len(req.output_tokens) >= req.params.max_new_tokens:
            finish = "length"
        else:
            finish = "stop"
        return {
            "id": rid,
            "object": "text_completion",
            "model": self.serve.config.arch,
            "choices": [{
                "index": 0,
                "token_ids": list(req.output_tokens),
                "text": self._decode(req.output_tokens, ticket),
                "finish_reason": finish,
            }],
            "usage": {
                "prompt_tokens": req.prompt_len,
                "completion_tokens": len(req.output_tokens),
                "total_tokens": req.prompt_len + len(req.output_tokens),
            },
            "slo": handle.slo(),
        }

    # -------------------------------------------------------- other endpoints
    def _cancel_endpoint(self, rid):
        ok = self.serve.cancel(rid)
        # the ticket (if any) is left in place: the pump delivers END on the
        # next pass and the stream closes with finish_reason "cancelled"
        self._wake.set()
        return HTTPResponse.json({"id": rid, "cancelled": bool(ok)},
                                 status=200 if ok else 404)

    def _healthz(self):
        workers = [{"worker_id": p.worker_id, "healthy": bool(p.healthy)}
                   for p in self.serve.engine.pairs]
        any_healthy = any(w["healthy"] for w in workers)
        return HTTPResponse.json(
            {"status": "ok" if any_healthy else "unhealthy",
             "pending": self.serve.pending,
             "max_pending": self.max_pending,
             "workers": workers},
            status=200 if any_healthy else 503,
        )

    def _fail_worker(self, raw):
        try:
            worker_id = int(raw)
        except ValueError:
            return HTTPResponse.error(400, f"bad worker id {raw!r}")
        if not any(p.worker_id == worker_id for p in self.serve.engine.pairs):
            return HTTPResponse.error(404, f"no worker {worker_id}")
        rerouted = self.serve.fail_worker(worker_id)
        self._wake.set()                 # orphans may need driving to terminal
        return HTTPResponse.json({"worker_id": worker_id,
                                  "rerouted": rerouted})

    def _client_dropped(self, rid):
        """SSE peer vanished mid-stream: cancel and free its slot/KV."""
        self._tickets.pop(rid, None)
        self.serve.cancel(rid)
        self._wake.set()

    # ------------------------------------------------------------------ misc
    def _encode(self, text):
        vocab = self.serve.arch.vocab_size
        return [t % vocab for t in self._tokenizer.encode(text)]

    def _decode(self, tokens, ticket):
        """Best-effort text for string-prompt clients; token-id clients
        read ``token_ids``/``token`` and get an empty string here."""
        return self._tokenizer.decode(tokens) if ticket.text_mode else ""


# ----------------------------------------------------------------- harnesses
def run_gateway(serve, host=None, port=None):
    """Foreground gateway (``launch/serve.py --http``): serve until Ctrl-C."""
    async def _main():
        gw = Gateway(serve, host=host, port=port)
        bound_host, bound_port = await gw.start()
        print(f"StreamServe gateway listening on http://{bound_host}:{bound_port}")
        print("  POST /v1/completions   (SSE with \"stream\": true)")
        print("  POST /v1/cancel/<id>   GET /healthz   GET /metrics")
        try:
            await asyncio.Event().wait()
        finally:
            await gw.stop()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        print("gateway stopped")


class GatewayThread:
    """Run a :class:`Gateway` on a dedicated thread with its own event loop.

    The harness tests and the load benchmark use this so client traffic
    (main thread) exercises the server over REAL sockets while the engine
    keeps its single-threaded discipline on the gateway loop.  ``start()``
    blocks until the listener is bound and returns ``(host, port)``.
    """

    def __init__(self, serve, host="127.0.0.1", port=0, max_pending=None):
        self.gateway = Gateway(serve, host=host, port=port,
                               max_pending=max_pending)
        self._loop = None
        self._thread = None
        self._ready = threading.Event()
        self._startup_error = None

    def start(self, timeout=30.0):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="streamserve-gateway")
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("gateway thread did not come up")
        if self._startup_error is not None:
            raise RuntimeError("gateway failed to start") from self._startup_error
        return self.gateway.host, self.gateway.port

    def _run(self):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            loop.run_until_complete(self.gateway.start())
        except Exception as e:          # surface bind errors to start()
            self._startup_error = e
            self._ready.set()
            loop.close()
            return
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(self.gateway.stop())
            loop.close()

    def call(self, fn, *args, timeout=30.0):
        """Run ``fn(*args)`` on the gateway loop (engine-safe) and return
        its result — the escape hatch for tests that must poke the
        engine without racing the step loop."""
        async def _invoke():
            return fn(*args)
        fut = asyncio.run_coroutine_threadsafe(_invoke(), self._loop)
        return fut.result(timeout)

    def stop(self, timeout=30.0):
        if self._loop is None:
            return
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout)
        self._loop = None
