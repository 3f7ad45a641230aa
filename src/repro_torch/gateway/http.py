"""Minimal asyncio HTTP/1.1 server with SSE streaming, stdlib only (a copy of
``repro.gateway.http``).

Request line, headers and Content-Length bodies in.  A non-SSE request that
sends ``Connection: keep-alive`` may reuse the connection (at most
:data:`MAX_KEEPALIVE_REQUESTS` a socket, :data:`KEEPALIVE_IDLE_S` idle
between requests); everything else, and every SSE stream, which owns its
connection until EOF, is answered ``Connection: close``.

* :class:`HTTPResponse` — a buffered status/headers/body reply.
* :class:`SSEResponse` — a ``text/event-stream`` reply whose body is an async
  iterator of frames, each written as ``data: <payload>`` and a blank line.
  A client that drops mid-stream (the read side hits EOF, or a write fails)
  is reported through ``on_disconnect``, so the gateway can cancel the
  request behind it.

This module knows nothing of the engine: the gateway supplies the
``async handler(request)``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Any, Dict
from urllib.parse import urlsplit

MAX_BODY = 8 * 1024 * 1024      # request-body cap (tokenised prompts are small)
MAX_HEADER_LINE = 16 * 1024
# keep-alive bounds: an abandoned open socket must not pin server state
MAX_KEEPALIVE_REQUESTS = 32
KEEPALIVE_IDLE_S = 5.0

STATUS_PHRASES = {
    200: "OK", 202: "Accepted", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout", 409: "Conflict",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}


@dataclasses.dataclass
class HTTPRequest:
    method: str
    path: str                      # path component only, query split off
    headers: Dict[str, str]        # keys lower-cased
    body: bytes

    def json(self):
        """The body parsed as JSON; ValueError on malformed input."""
        if not self.body:
            return {}
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as e:
            raise ValueError(f"malformed JSON body: {e}") from e


@dataclasses.dataclass
class HTTPResponse:
    status: int = 200
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    body: bytes = b""

    @classmethod
    def json(cls, obj: Any, status=200, headers=None):
        return cls(status=status, headers={"Content-Type": "application/json", **(headers or {})},
                   body=json.dumps(obj).encode("utf-8"))

    @classmethod
    def text(cls, text, status=200, content_type="text/plain; charset=utf-8"):
        return cls(status=status, headers={"Content-Type": content_type},
                   body=text.encode("utf-8"))

    @classmethod
    def error(cls, status, message, code=None, headers=None, **extra):
        payload = {"error": {"message": message,
                             "type": code or STATUS_PHRASES.get(status, "error"), **extra}}
        return cls.json(payload, status=status, headers=headers)


class SSEResponse:
    """Server-Sent Events stream: ``source`` yields frames (a ``str`` is
    written verbatim as the ``data:`` payload, anything else JSON-encoded);
    ``on_disconnect`` fires once if the client drops before the source ends."""

    def __init__(self, source, on_disconnect=None, headers=None):
        self.source = source
        self.on_disconnect = on_disconnect
        self.headers = {"Content-Type": "text/event-stream", "Cache-Control": "no-cache",
                        **(headers or {})}


class AsyncHTTPServer:
    """HTTP/1.1 server over asyncio streams (opt-in keep-alive, SSE close)."""

    def __init__(self, handler, host="127.0.0.1", port=0):
        self.handler = handler
        self.host = host
        self.port = port             # 0 = ephemeral; the bound port after start()
        self._server = None

    async def start(self):
        self._server = await asyncio.start_server(self._serve_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _serve_connection(self, reader, writer):
        try:
            for served in range(MAX_KEEPALIVE_REQUESTS):
                if served == 0:
                    request = await self._read_request(reader)
                else:  # between keep-alive requests: a bounded idle wait
                    try:
                        request = await asyncio.wait_for(self._read_request(reader),
                                                         KEEPALIVE_IDLE_S)
                    except asyncio.TimeoutError:
                        break
                if request is None:
                    break
                try:
                    response = await self.handler(request)
                except ValueError as e:   # handler-level validation error
                    response = HTTPResponse.error(400, str(e))
                except Exception as e:    # never kill the accept loop
                    response = HTTPResponse.error(500, f"{type(e).__name__}: {e}")
                if isinstance(response, SSEResponse):
                    await self._write_sse(response, reader, writer)  # owns the connection
                    break
                keep = (served + 1 < MAX_KEEPALIVE_REQUESTS
                        and request.headers.get("connection", "").lower() == "keep-alive")
                await self._write_response(response, writer, keep_alive=keep)
                if not keep:
                    break
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _read_request(self, reader):
        try:
            line = await reader.readline()
        except (ConnectionResetError, asyncio.LimitOverrunError):
            return None
        if not line or len(line) > MAX_HEADER_LINE:
            return None
        try:
            method, target, _version = line.decode("latin-1").split(None, 2)
        except ValueError:
            return None
        headers = {}
        while True:
            line = await reader.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
            if len(line) > MAX_HEADER_LINE or len(headers) > 100:
                return None
            name, _, value = line.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or "0")
        if length < 0 or length > MAX_BODY:
            return None
        body = await reader.readexactly(length) if length else b""
        return HTTPRequest(method=method.upper(), path=urlsplit(target).path, headers=headers,
                           body=body)

    async def _write_response(self, resp, writer, keep_alive=False):
        headers = {"Content-Length": str(len(resp.body)),
                   "Connection": "keep-alive" if keep_alive else "close", **resp.headers}
        if keep_alive:
            headers.setdefault("Keep-Alive",
                               f"timeout={int(KEEPALIVE_IDLE_S)}, max={MAX_KEEPALIVE_REQUESTS}")
        writer.write(self._head(resp.status, headers))
        writer.write(resp.body)
        await writer.drain()

    async def _write_sse(self, resp, reader, writer):
        """Stream frames, racing each one against client disconnect.  SSE
        clients send nothing after the request, so any read completion (data
        or EOF) means the peer is gone: waiting on the read side catches a
        disconnect even while the source is idle between tokens."""
        writer.write(self._head(200, {**resp.headers, "Connection": "close"}))
        await writer.drain()
        aiter = resp.source.__aiter__()
        eof_task = asyncio.ensure_future(reader.read(1))
        disconnected = False
        try:
            while True:
                next_task = asyncio.ensure_future(aiter.__anext__())
                done, _ = await asyncio.wait({next_task, eof_task},
                                             return_when=asyncio.FIRST_COMPLETED)
                if eof_task in done and next_task not in done:
                    next_task.cancel()
                    disconnected = True
                    break
                try:
                    frame = next_task.result()
                except StopAsyncIteration:
                    break
                payload = frame if isinstance(frame, str) else json.dumps(frame)
                try:
                    writer.write(f"data: {payload}\n\n".encode("utf-8"))
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError, OSError):
                    disconnected = True
                    break
        finally:
            eof_task.cancel()
            aclose = getattr(aiter, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:
                    pass
            if disconnected and resp.on_disconnect is not None:
                resp.on_disconnect()

    @staticmethod
    def _head(status, headers):
        lines = [f"HTTP/1.1 {status} {STATUS_PHRASES.get(status, 'Unknown')}",
                 *(f"{k}: {v}" for k, v in headers.items())]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
