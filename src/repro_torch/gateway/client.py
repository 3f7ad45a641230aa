"""Stdlib HTTP/SSE clients for the gateway (a port of
``repro.gateway.client``): :func:`http_request` and :class:`SSEClient` speak
``Connection: close``, :class:`KeepAliveClient` reuses one socket for
non-SSE requests, :func:`arequest` and :func:`asse_collect` are their
asyncio counterparts for load generators; SSE frames are ``data:`` lines
separated by blank lines, ended by ``data: [DONE]``.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import socket
from time import perf_counter


def _encode_request(method, path, host, body, connection="close"):
    payload = b""
    if body is not None:
        payload = body if isinstance(body, bytes) else json.dumps(body).encode()
    head = (f"{method} {path} HTTP/1.1\r\nHost: {host}\r\nContent-Length: {len(payload)}\r\n"
            f"Content-Type: application/json\r\nConnection: {connection}\r\n\r\n")
    return head.encode("latin-1") + payload


def _payloads(frame):
    """The payloads of an SSE frame's ``data:`` lines."""
    return [line.strip()[5:].strip() for line in frame.splitlines()
            if line.strip().startswith(b"data:")]


def _parse_head(head):
    """(status, headers with lower-cased names) of a response head."""
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip()
               for k, _, v in (ln.partition(":") for ln in lines[1:] if ":" in ln)}
    return int(lines[0].split(None, 2)[1]), headers


class _Connection:
    """One socket to the gateway with a read buffer; closed on exit."""

    def __init__(self, host, port, timeout):
        self.host = host
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""

    def _recv(self, what):
        chunk = self.sock.recv(65536)
        if not chunk:
            raise ConnectionError(f"server closed {what}")
        self._buf += chunk

    def _read_until(self, sep, what="the connection"):
        while sep not in self._buf:
            self._recv(what)
        out, _, self._buf = self._buf.partition(sep)
        return out

    def _read_head(self):
        return _parse_head(self._read_until(b"\r\n\r\n", "before headers"))

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class KeepAliveClient(_Connection):
    """Blocking client that reuses ONE socket across buffered requests: each
    response is read by its ``Content-Length``, so the socket stays at the
    next response head.  ``closed`` flips when the server announces
    ``Connection: close`` (its per-connection bound).  Not for SSE."""

    def __init__(self, host, port, timeout=30.0, connection="keep-alive"):
        super().__init__(host, port, timeout)
        self.connection = connection
        self.closed = False

    def request(self, method, path, body=None):
        if self.closed:
            raise ConnectionError("keep-alive connection already closed")
        self.sock.sendall(_encode_request(method, path, self.host, body, self.connection))
        status, headers = self._read_head()
        want = int(headers.get("content-length", "0") or "0")
        while len(self._buf) < want:
            self._recv("mid-body")
        payload, self._buf = self._buf[:want], self._buf[want:]
        if headers.get("connection", "").lower() == "close":
            self.closed = True
        return status, headers, payload

    def close(self):
        self.closed = True
        super().close()


def http_request(host, port, method, path, body=None, timeout=120.0):
    """One buffered request/response exchange; returns (status, headers, body)."""
    with KeepAliveClient(host, port, timeout, connection="close") as client:
        return client.request(method, path, body)


class SSEClient(_Connection):
    """Blocking SSE reader: iterate :meth:`events` for the decoded ``data:``
    payloads (``[DONE]`` ends them and sets ``done``); ``close()`` drops the
    connection at any time, which the gateway must notice and cancel the
    request behind it."""

    def __init__(self, host, port, path, body, timeout=120.0):
        super().__init__(host, port, timeout)
        self.sock.sendall(_encode_request("POST", path, host, body))
        self.status, self.headers = self._read_head()
        self.done = False

    def events(self):
        """Decoded frames until ``[DONE]`` (exclusive) or server close."""
        while True:
            try:
                frame = self._read_until(b"\n\n", "the SSE stream early")
            except ConnectionError:
                return
            for payload in _payloads(frame):
                if payload == b"[DONE]":
                    self.done = True
                    return
                yield json.loads(payload)


async def _close(writer):
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionResetError, OSError):
        pass


async def arequest(host, port, method, path, body=None):
    """Async buffered request: (status, headers, body), read to EOF."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(_encode_request(method, path, host, body))
        await writer.drain()
        raw = await reader.read()
    finally:
        await _close(writer)
    head, _, rest = raw.partition(b"\r\n\r\n")
    return (*_parse_head(head), rest)


async def asse_collect(host, port, path, body):
    """One streaming completion, every frame stamped: ``{status, frames,
    frame_times, t_submit, t_first, t_last, terminal, error}`` (the client's
    TTFT and TPOT), stamps in ``perf_counter`` seconds.  The terminal frame
    (``usage`` or ``error``) is kept apart from the token frames; a non-200
    reply's JSON body is the terminal."""
    out = {"status": None, "frames": [], "frame_times": [], "t_submit": perf_counter(),
           "t_first": None, "t_last": None, "terminal": None, "error": None}
    try:
        reader, writer = await asyncio.open_connection(host, port)
    except OSError as e:
        out["error"] = f"connect: {e}"
        return out
    try:
        writer.write(_encode_request("POST", path, host, body))
        await writer.drain()
        out["error"] = "closed before headers"  # until the head arrives
        out["status"] = _parse_head((await reader.readuntil(b"\r\n\r\n"))[:-4])[0]
        out["error"] = None
        if out["status"] != 200:
            with contextlib.suppress(json.JSONDecodeError):
                out["terminal"] = json.loads(await reader.read())
            return out
        while True:
            for payload in _payloads(await reader.readuntil(b"\n\n")):
                if payload == b"[DONE]":
                    return out
                now, decoded = perf_counter(), json.loads(payload)
                if "error" in decoded or "usage" in decoded:
                    out["terminal"] = decoded
                    if "error" in decoded:
                        out["error"] = decoded["error"].get("code", "failed")
                else:
                    out["t_first"] = out["t_first"] or now
                    out["t_last"] = now
                    out["frames"].append(decoded)
                    out["frame_times"].append(now)
    except asyncio.IncompleteReadError:
        out["error"] = out["error"] or "closed mid-stream"
        return out
    finally:
        await _close(writer)


def completion_body(prompt, max_tokens, stream=True, **extra):
    """The ``/v1/completions`` request body."""
    return {"prompt": prompt, "max_tokens": max_tokens, "stream": stream, **extra}
