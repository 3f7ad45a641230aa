"""The port's HTTP gateway and serve CLI on the CPU.

The JAX gateway and the port's run on the same fp32 weights, each on its own
``GatewayThread``, over real localhost sockets: one request at a time gives
the same SSE frames, terminal payloads, JSON bodies, 400s, ``/healthz`` and
``/metrics`` (request ids aside: each package numbers its own).  Concurrent
traffic depends on arrival ticks, so it is held to the reference's
properties instead.  Every wait is bounded (client timeouts, thread
start/call/stop timeouts, drain deadlines).

    PYTHONPATH=src python -m pytest -q tests/test_torch_gateway.py
"""
import asyncio
import concurrent.futures
import json
import time
from pathlib import Path

import pytest
import yaml
from test_torch_engine import _one_torch_thread, fp32_model  # noqa: F401

import repro.api as jax_api
import repro.gateway as jax_gateway
import repro.gateway.client as jax_client
from repro_torch.api import ServeConfig, StreamServe
from repro_torch.gateway import GatewayThread
from repro_torch.gateway import client as port_client
from repro_torch.gateway.client import KeepAliveClient, SSEClient, completion_body, http_request
from repro_torch.launch import serve as serve_cli

PROMPT = list(range(2, 12))
TIMEOUT = 60.0


def _start(serve, max_pending=32, thread_cls=GatewayThread):
    thread = thread_cls(serve, port=0, max_pending=max_pending)
    host, port = thread.start(timeout=TIMEOUT)
    return {"thread": thread, "serve": serve, "host": host, "port": port}


@pytest.fixture(scope="module")
def gateways(fp32_model):
    """The JAX gateway and the port's over the same weights."""
    jcfg, jparams, tcfg, tparams = fp32_model
    cfg = {"n_pairs": 2, "max_batch": 2}
    jax = _start(jax_api.StreamServe(jax_api.ServeConfig.reduced_smoke(**cfg), params=jparams,
                                     arch_cfg=jcfg), thread_cls=jax_gateway.GatewayThread)
    port = _start(StreamServe(ServeConfig.reduced_smoke(**cfg), params=tparams, arch_cfg=tcfg,
                              device="cpu"))
    jax["client"], port["client"] = jax_client, port_client
    yield jax, port
    for gw in (jax, port):
        gw["thread"].stop(timeout=TIMEOUT)


@pytest.fixture(scope="module")
def gw(gateways):
    return gateways[1]


def _on_loop(gw, fn):
    """``fn()`` run on the gateway's event loop (engine-safe)."""
    return gw["thread"].call(fn, timeout=TIMEOUT)


def _until(what, cond):
    deadline = time.perf_counter() + TIMEOUT
    while not cond():
        assert time.perf_counter() < deadline, what
        time.sleep(0.02)


def _drain(gw):
    """Wait until the engine has nothing in flight."""
    _until("the engine did not drain", lambda: _on_loop(gw, lambda: gw["serve"].pending) == 0)


def _anon(obj, rid):
    """A reply with its request id replaced (each package counts its own)."""
    return json.loads(json.dumps(obj).replace(json.dumps(rid), '"<id>"'))


def _exchange(gw, method, path, body=None, via_async=False):
    if via_async:
        status, headers, raw = asyncio.run(gw["client"].arequest(gw["host"], gw["port"], method,
                                                                 path, body))
    else:
        status, headers, raw = http_request(gw["host"], gw["port"], method, path, body,
                                            timeout=TIMEOUT)
    _drain(gw)
    return status, headers.get("content-type"), raw


def _client(gw, body, drop_after=None):
    """One SSE stream: its frames and their arrival times (the first
    ``drop_after`` frames, then the socket is dropped)."""
    frames, times = [], []
    with SSEClient(gw["host"], gw["port"], "/v1/completions", body, timeout=TIMEOUT) as sse:
        for f in sse.events():
            frames.append(f)
            times.append(time.perf_counter())
            if len(frames) == drop_after:
                break
    return frames, times


def _reply(gw, kind, body):
    """One request's reply, its request id anonymised."""
    if kind == "stream":
        frames = _client(gw, body)[0]
        _drain(gw)
        return _anon(frames, frames[0]["id"])
    if kind == "astream":  # asse_collect: its stamps in order, then its frames
        got = asyncio.run(gw["client"].asse_collect(gw["host"], gw["port"], "/v1/completions",
                                                    body))
        _drain(gw)
        times, t = got.pop("frame_times"), [got.pop(k) for k in ("t_submit", "t_first", "t_last")]
        assert len(times) == len(got["frames"]) and times == sorted(times)
        assert not times or t[0] <= t[1] == times[0] <= t[2] == times[-1]
        return _anon(got, got["frames"][0]["id"]) if got["frames"] else got
    status, ctype, raw = _exchange(gw, "POST", "/v1/completions", body, kind == "ajson")
    payload = json.loads(raw)
    return status, ctype, _anon(payload, payload.get("id"))


def test_single_requests_match_the_jax_gateway(gateways):
    """Streaming and not, token ids and a string, a prompt over the context,
    then /healthz and /metrics: the same bytes from both gateways."""
    replies = []
    for kind, body in (
            ("stream", completion_body(PROMPT, 5)),
            ("json", completion_body(PROMPT[:7], 4, stream=False)),
            ("stream", {"prompt": "hello stream", "max_tokens": 3, "stream": True}),
            ("json", {"prompt": "hello stream", "max_tokens": 6, "stream": False}),
            ("json", completion_body(list(range(90)), 12, stream=False)),  # over max_len
            ("stream", completion_body(PROMPT[3:], 9, slo_ttft=50.0, slo_tpot=4.0))):
        got, want = (_reply(gw, kind, body) for gw in gateways[::-1])
        assert got == want, body
        replies.append(got)
    for frames, n in ((replies[0], 5), (replies[2], 3), (replies[5], 9)):
        tokens = [f["choices"][0]["token"] for f in frames[:-1]]
        assert frames[-1]["choices"][0]["token_ids"] == tokens and len(tokens) == n
        assert frames[-1]["usage"]["completion_tokens"] == n
        assert frames[-1]["choices"][0]["finish_reason"] == "length"
    assert replies[1][0] == 200 and replies[1][2]["slo"]["state"] == "finished"
    assert isinstance(replies[3][2]["choices"][0]["text"], str)
    assert replies[4][0] == 400 and "exceeds max_len" in replies[4][2]["error"]["message"]
    for path in ("/healthz", "/metrics", "/nope"):
        assert _exchange(gateways[1], "GET", path) == _exchange(gateways[0], "GET", path), path
    assert b"streamserve_tokens_generated_total 27" in _exchange(gateways[1], "GET", "/metrics")[2]


def test_async_clients_match_the_jax_gateway(gateways):
    """arequest and asse_collect, each package's against its own gateway: a
    buffered completion, a stream, a stream refused for its length."""
    replies = []
    for kind, body in (("ajson", completion_body(PROMPT[:7], 4, stream=False)),
                       ("astream", completion_body(PROMPT, 5)),
                       ("astream", completion_body(list(range(90)), 12))):
        got, want = (_reply(gw, kind, body) for gw in gateways[::-1])
        assert got == want, body
        replies.append(got)
    assert replies[0][0] == 200 and len(replies[1]["frames"]) == 5 and not replies[1]["error"]
    assert replies[2]["status"] == 400 and "max_len" in replies[2]["terminal"]["error"]["message"]


def test_keepalive_and_close(gw):
    with KeepAliveClient(gw["host"], gw["port"], timeout=TIMEOUT) as ka:
        for _ in range(3):
            status, headers, body = ka.request("GET", "/healthz")
            assert status == 200 and headers["connection"] == "keep-alive"
            assert "keep-alive" in headers and json.loads(body)["status"] == "ok"
        status, headers, body = ka.request("POST", "/v1/completions",
                                           completion_body(PROMPT, 2, stream=False))
        assert status == 200 and headers["connection"] == "keep-alive" and not ka.closed
        assert len(json.loads(body)["choices"][0]["token_ids"]) == 2
    status, headers, _ = http_request(gw["host"], gw["port"], "GET", "/healthz", timeout=TIMEOUT)
    assert status == 200 and headers["connection"] == "close"
    with SSEClient(gw["host"], gw["port"], "/v1/completions", completion_body(PROMPT, 2),
                   timeout=TIMEOUT) as sse:
        assert sse.headers["connection"] == "close" and len(list(sse.events())) == 3
    for method, path, body, want in (("GET", "/v1/completions", None, 405),
                                     ("POST", "/v1/completions", b"{not json", 400),
                                     ("POST", "/v1/completions", {"prompt": []}, 400),
                                     ("POST", "/v1/cancel/req-nope", None, 404),
                                     ("POST", "/admin/fail_worker/x", None, 400),
                                     ("POST", "/admin/fail_worker/7", None, 404)):
        assert http_request(gw["host"], gw["port"], method, path, body,
                            timeout=TIMEOUT)[0] == want, path
    _drain(gw)


def _tokens(frames):
    return [f["choices"][0]["token"] for f in frames if "token" in f.get("choices", [{}])[0]]


def _terminals(frames):
    return [f for f in frames if "usage" in f or "error" in f]


def _records(gw):
    return _on_loop(gw, lambda: {r.request_id: r for r in gw["serve"].monitor.completed})


def _free(gw):
    return _on_loop(gw, lambda: [(p.kv.free_blocks, len(p.free_slots()))
                                 for p in gw["serve"].engine.pairs])


def test_concurrent_streams_interleave_and_a_dropped_stream_frees_its_slot(gw):
    """8 streams on 4 slots: each gets its request's tokens and streams
    overlap in time; a stream dropped after 2 frames is cancelled, and every
    slot and page comes back."""
    _drain(gw)
    baseline = _free(gw)
    with concurrent.futures.ThreadPoolExecutor(max_workers=9) as pool:
        futures = [pool.submit(_client, gw, completion_body(PROMPT[:6] + [20 + i], 6))
                   for i in range(8)]
        dropped = pool.submit(_client, gw, completion_body(PROMPT, 60), drop_after=2)
        results = [f.result(timeout=TIMEOUT) for f in futures]
        rid = dropped.result(timeout=TIMEOUT)[0][0]["id"]
    _until("the dropped stream was not cancelled",
           lambda: rid in _records(gw) and _records(gw)[rid].cancelled)
    _drain(gw)
    recs = _records(gw)
    for frames, _ in results:
        (terminal,) = _terminals(frames)
        assert _tokens(frames) == terminal["choices"][0]["token_ids"]
        assert recs[frames[0]["id"]].generated == terminal["usage"]["completion_tokens"] == 6
    spans = [(t[0], t[-1]) for _, t in results]
    assert any(a0 < b1 and b0 < a1 for i, (a0, a1) in enumerate(spans) for b0, b1 in spans[i + 1:])
    assert _free(gw) == baseline
    assert 'streamserve_requests_total{state="cancelled"} 1' in _on_loop(
        gw, gw["serve"].prometheus_text)


def test_backpressure_429_and_cancel_endpoint(gw):
    _drain(gw)
    _on_loop(gw, lambda: setattr(gw["thread"].gateway, "max_pending", 1))
    try:
        with SSEClient(gw["host"], gw["port"], "/v1/completions", completion_body(PROMPT, 60),
                       timeout=TIMEOUT) as sse:
            events = sse.events()
            rid = next(events)["id"]             # admitted and decoding: pending 1
            status, headers, body = http_request(gw["host"], gw["port"], "POST",
                                                 "/v1/completions", completion_body(PROMPT, 4),
                                                 timeout=TIMEOUT)
            assert status == 429 and headers["retry-after"] == "1"
            assert json.loads(body)["error"]["type"] == "overloaded"
            assert _on_loop(gw, lambda: gw["thread"].gateway.rejected_429) >= 1
            status, _, body = http_request(gw["host"], gw["port"], "POST", f"/v1/cancel/{rid}",
                                           timeout=TIMEOUT)
            assert status == 200 and json.loads(body) == {"id": rid, "cancelled": True}
            (terminal,) = _terminals(list(events))  # the stream ends on its own
            assert terminal["choices"][0]["finish_reason"] == "cancelled"
    finally:
        _on_loop(gw, lambda: setattr(gw["thread"].gateway, "max_pending", 32))
    _drain(gw)


def test_fail_worker_under_live_load_ends_every_stream_once():
    """Pair 0 killed over the admin endpoint while 10 streams are live: each
    client sees exactly one terminal frame, the monitor one record each."""
    gw = _start(StreamServe(ServeConfig.reduced_smoke(n_pairs=2, max_batch=2), device="cpu"),
                max_pending=64)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=10) as pool:
            futures = [pool.submit(_client, gw, completion_body(PROMPT[:6] + [30 + i], 8))
                       for i in range(10)]
            _until("no stream went live", lambda: _on_loop(gw, lambda: gw["serve"].engine._now) > 2)
            status, _, body = http_request(gw["host"], gw["port"], "POST", "/admin/fail_worker/0",
                                           timeout=TIMEOUT)
            assert status == 200 and json.loads(body)["worker_id"] == 0
            transcripts = [f.result(timeout=TIMEOUT)[0] for f in futures]
        assert all(len(_terminals(t)) == 1 for t in transcripts)
        assert any("usage" in _terminals(t)[0] for t in transcripts)
        status, _, body = http_request(gw["host"], gw["port"], "GET", "/healthz", timeout=TIMEOUT)
        assert status == 200
        assert [w["healthy"] for w in json.loads(body)["workers"]] == [False, True]
        ids = list(_records(gw))
        assert len(ids) == len(set(ids)) == 10
        assert len(_on_loop(gw, lambda: gw["serve"].flight_dumps)) == 0  # trace off
    finally:
        gw["thread"].stop(timeout=TIMEOUT)


# --------------------------------------------------------------------- CLI
def test_serve_cli_config_flags_and_a_faulted_traced_run(tmp_path, capsys):
    path = str(tmp_path / "serve.yaml")
    assert serve_cli.main(["--dump-config", path, "--pairs", "3", "--trace", "flight"]) \
        ["config"] == ServeConfig.from_yaml(path)
    loaded = yaml.safe_load(Path(path).read_text())
    assert loaded["n_pairs"] == 3 and loaded["max_len"] == 192 and loaded["trace"] == "flight"
    cfg = serve_cli.main(["--config", path, "--max-new", "5", "--dump-config", path])["config"]
    assert (cfg.n_pairs, cfg.max_new_tokens, cfg.trace) == (3, 5, "flight")
    out = str(tmp_path / "x.json")
    run = serve_cli.main(["--device", "cpu", "--requests", "6", "--cancel-one", "--fail-worker",
                          "1", "--trace-out", out])
    printed = capsys.readouterr().out
    assert "completed 5/6" in printed and "!! killed stream pair 1" in printed
    serve = run["serve"]
    assert serve.config.trace == "on" and len(serve.flight_dumps) == 1
    assert serve.summary()["cancelled"] == 1 and not serve.engine.pairs[1].healthy
    doc = json.loads(Path(out).read_text())
    assert {e["pid"] for e in doc["traceEvents"]} == {0, 1}
