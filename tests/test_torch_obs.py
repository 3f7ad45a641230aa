"""StreamTrace on the PyTorch port against the JAX engine, on the CPU: the
same weights and traces with ``trace="on"`` give the same event stream, the
same Chrome trace, Prometheus text, flight dumps and worker stats, floats
compared exactly; plus the port's sampling filters and workload suites
against the reference's.

    PYTHONPATH=src python -m pytest -q tests/test_torch_obs.py
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import PAGED, _copy, _engines, _records, _serve, fp32_pair
from test_torch_engine import _one_torch_thread, fp32_model, fp32_models  # noqa: F401

import repro.api.frontend as jax_frontend
import repro.data.workloads as jax_workloads
import repro.serving.sampling as jax_sampling
from repro.obs.spans import worker_timelines as jax_timelines
from repro.serving.request import Request as JaxRequest
from repro.serving.request import SamplingParams as JaxSampling
from repro_torch.api.frontend import StreamServe
from repro_torch.data import workloads
from repro_torch.obs import spans, trace
from repro_torch.serving import sampling
from tools.traceview.cli import main as traceview_main


def _stats(cls, engine):
    """``worker_stats()`` of a front end over ``engine``."""
    serve = object.__new__(cls)
    serve.engine = engine
    return serve.worker_stats()


def _preempt_trace(vocab, n_long=80):
    """A long prompt, then a tight-deadline arrival that parks it at a chunk
    boundary (EDF preemption), as the reference's test_obs does."""
    rng = np.random.default_rng(7)
    long = JaxRequest(prompt=rng.integers(0, vocab, n_long).tolist(),
                      params=JaxSampling(max_new_tokens=4))
    tight = JaxRequest(prompt=rng.integers(0, vocab, 20).tolist(),
                       params=JaxSampling(max_new_tokens=4), slo_ttft=3.0, arrival_time=1.0)
    return [long, tight]


REQUEUE = {"n": 4, "lo": 24, "hi": 33, "max_new": 24}  # test_torch_paged's pressure trace
# case -> (arch, pairs, engine overrides, trace and its kwargs, fail (pair,
# tick), cancel (index, tick), steps (None: drain), events the case must record)
CASES = {
    "dense-bursty": ("qwen3-1.7b", 2, {}, ("bursty", {}), None, None, None,
                     {"verify", "kv_alloc", "counters"}),
    "dense-uniform-cancel": ("qwen3-1.7b", 2, {}, ("uniform", {}), None, (4, 9), None,
                             {"cancel"}),
    "dense-mixed_slo-shed": ("qwen3-1.7b", 2, {"max_batch": 1}, ("mixed_slo", {}), None, None,
                             None, {"shed", "fail"}),
    "dense-fail": ("qwen3-1.7b", 2, {}, ("bursty", {}), (0, 3), None, None, {"worker_fail"}),
    "paged-fail": ("qwen3-1.7b", 2, PAGED, ("uniform", {}), (1, 4), None, None,
                   {"worker_fail"}),
    # the reference's requeue trace never drains (ROADMAP): 40 steps of it
    "paged-requeue": ("qwen3-1.7b", 1, {**PAGED, "kv_blocks": 7}, ("bursty", REQUEUE), None,
                      None, 40, {"kv_evict", "kv_requeue"}),
    "chunked-preempt": ("qwen3-1.7b", 1, {"prefill_chunk": 16, "max_batch": 3},
                        ("preempt", {}), None, None, None,
                        {"prefill_chunk", "prefill_preempt", "prefill_resume"}),
    "mamba2": ("mamba2-2.7b", 2, {}, ("bursty", {}), None, None, None, {"decode_step"}),
}


@pytest.fixture(scope="module")
def pairs(fp32_model):
    made = {"qwen3-1.7b": fp32_model}

    def get(arch):
        if arch not in made:
            made[arch] = fp32_pair(arch)
        return made[arch]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_trace_and_exporters_match_jax_engine(pairs, trace_factory, tmp_path, case):
    arch, n_pairs, econf, (name, kw), fail, cancel, steps, must = CASES[case]
    pair = pairs(arch)
    jreqs = (_preempt_trace(pair[0].vocab_size) if name == "preempt"
             else trace_factory(name, **{"n": 6, "lo": 6, "hi": 50, **kw}))
    treqs = _copy(jreqs)
    engines = _engines(pair, n_pairs, trace="on", **econf)
    for engine, reqs, d in zip(engines, (jreqs, treqs), ("jax", "torch"), strict=True):
        engine.econf.trace_dir = str(tmp_path / d)  # each engine's dumps apart
        _serve(engine, reqs, steps or 600, fail, cancel, drain=not steps)
    jeng, teng = engines
    events = teng.trace_events()
    assert events == jeng.trace_events()
    assert must <= {trace.EVENT_NAMES[e[3]] for e in events}
    assert json.dumps(teng.export_chrome_trace()) == json.dumps(jeng.export_chrome_trace())
    assert teng.prometheus_text() == jeng.prometheus_text()
    assert json.dumps(teng.flight_dumps) == json.dumps(jeng.flight_dumps)
    assert len(teng.flight_dumps) == bool(fail)
    dumps = [{p.name: p.read_text() for p in (tmp_path / d).glob("*.json")}
             for d in ("torch", "jax")]
    assert dumps[0] == dumps[1] and len(dumps[0]) == bool(fail)
    assert _stats(StreamServe, teng) == _stats(jax_frontend.StreamServe, jeng)
    assert spans.worker_timelines(events) == jax_timelines(jeng.trace_events())
    assert _records(teng) == _records(jeng)
    assert [r.output_tokens for r in treqs] == [r.output_tokens for r in jreqs]


@pytest.mark.parametrize("econf", [{}, PAGED, {"prefill_chunk": 16}], ids=["dense", "paged",
                                                                          "chunked"])
def test_trace_off_records_nothing_and_serves_the_same(fp32_model, trace_factory, econf):
    runs, trace_ = [], trace_factory("mixed_slo", n=6, lo=6, hi=50)
    for mode in ("off", "on"):
        reqs = _copy(trace_)
        engine = _engines(fp32_model, 2, trace=mode, **econf)[1]
        _serve(engine, reqs, fail=(1, 5))
        runs.append((engine, reqs))
    (off, off_reqs), (on, on_reqs) = runs
    assert off.trace_events() == [] and off.flight_dumps == []
    assert isinstance(off.trace, trace.NullRecorder)
    assert on.trace_events() and len(on.flight_dumps) == 1
    assert [r.output_tokens for r in off_reqs] == [r.output_tokens for r in on_reqs]
    assert _records(off) == _records(on)


def test_flight_dumps_render_through_traceview(fp32_model, trace_factory, tmp_path, capsys):
    engine = _engines(fp32_model, 2, trace="on", trace_dir=str(tmp_path))[1]
    _serve(engine, _copy(trace_factory("bursty", n=4)), fail=(0, 2))
    (dumped,) = tmp_path.glob("flight_fail_worker_tick2.json")
    assert traceview_main([str(dumped), "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "slowest requests" in out and "per-worker occupancy" in out and "decode_step" in out

    def boom(now):
        raise RuntimeError("injected decode fault")

    for r in _copy(trace_factory("bursty", n=2)):
        engine.submit(r)
    engine.step()
    engine.pairs[1].decode_iteration = boom
    with pytest.raises(RuntimeError, match="injected decode fault"):
        engine.step()
    assert engine.flight_dumps[-1]["reason"] == "engine_exception"
    (dumped,) = tmp_path.glob("flight_engine_exception_*.json")
    assert json.loads(dumped.read_text())["events"]


@pytest.mark.parametrize("temperature, top_k, top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (0.7, 64, 1.0), (0.7, 100, 1.0), (1.3, 0, 0.9),
    (0.5, 8, 0.6), (1.0, 1, 0.3), (0.0, 5, 0.5)])
def test_top_k_top_p_match_the_reference(temperature, top_k, top_p):
    logits = np.random.default_rng(top_k + 17).normal(size=(6, 64)).astype(np.float32) * 3
    t, j = torch.from_numpy(logits), jnp.asarray(logits)
    for got, want in ((sampling.apply_top_k(t, top_k), jax_sampling.apply_top_k(j, top_k)),
                      (sampling.apply_top_p(t, top_p), jax_sampling.apply_top_p(j, top_p)),
                      (sampling.token_probs(t, temperature, top_k, top_p),
                       jax_sampling.token_probs(j, temperature, top_k, top_p))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    toks = sampling.sample(gen, t, temperature, top_k, top_p)
    probs = sampling.token_probs(t, temperature, top_k, top_p)
    assert (probs.gather(-1, toks[:, None]) > 0).all()  # never a filtered token


def _draws(sims, n=5):
    rng = np.random.default_rng(11)
    return [[s.acceptance.step(rng) for _ in range(n)] for s in sims]


def _fields(sims):
    return [(s.request.prompt, s.request.params.max_new_tokens, s.request.arrival_time,
             s.request.slo_ttft, s.request.slo_tpot, s.arrival, s.acceptance.base,
             s.acceptance.vol, s.acceptance.rho) for s in sims]


@pytest.mark.parametrize("seed", [0, 3])
def test_workloads_match_the_reference(seed):
    for suite in workloads.WORKLOADS:
        kw = {"seed": seed, "vocab_size": 1000, "arrival_rate": 2.0 if seed else None}
        got, want = (workloads.sample_requests(suite, 12, **kw),
                     jax_workloads.sample_requests(suite, 12, **kw))
        assert _fields(got) == _fields(want) and _draws(got) == _draws(want)
        assert _fields(workloads.make_workload(suite, n=4, seed=seed, max_new_override=7)) \
            == _fields(jax_workloads.make_workload(suite, n=4, seed=seed, max_new_override=7))
    got, want = (workloads.sample_mixed(5, seed=seed, arrival_rate=1.5),
                 jax_workloads.sample_mixed(5, seed=seed, arrival_rate=1.5))
    assert _fields(got) == _fields(want) and _draws(got) == _draws(want)
