"""Chunked prefill with EDF preemption (M6) in the port against the JAX
engine, in float32 on the reduced qwen3 (and mamba2, where the architecture
gate leaves chunking off): token-identical greedy outputs, the same
``worker_id`` and equal ``RequestRecord``s, dense and paged, with preemption
on and off, under cancellation and worker failure.  Every chunk step is one
(R, C) decode step, so on the card it runs K1 (and paged decode K3); the
kernels themselves are held to their plain versions by ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest
from test_torch_engine import PAGED, TRACES, _copy, _engines, _records, _serve, _serve_both
from test_torch_engine import _one_torch_thread, fp32_model, fp32_models  # noqa: F401

from repro.serving.cost_model import TPU_V5E
from repro.serving.cost_model import PrefillDelayEstimator as JaxEstimator
from repro.serving.request import Request as JaxRequest
from repro.serving.request import SamplingParams as JaxSampling
from repro_torch.api import ServeConfig, StreamServe
from repro_torch.configs import reduced_config
from repro_torch.serving.cost_model import HardwareProfile, PrefillDelayEstimator
from repro_torch.serving.request import Request, RequestState

CHUNK = {"prefill_chunk": 16}
# case -> (arch, engine overrides, pairs, trace, its prompt lengths, (pair,
# tick) that fails or None).  Dense and paged on the three traces; a chunk
# of 48 clamped to a divisor of the capacity 100; a pair dying with chunks
# in flight, and the last one dying; a paged prompt over max_len; mamba2,
# whose SSM layers turn chunking off
CASES = {f"{kv}-{t}": ("qwen3-1.7b", {**CHUNK, **(PAGED if kv == "paged" else {})}, 2, t,
                       (6, 50), None) for kv in ("dense", "paged") for t in TRACES}
CASES.update({
    "divisor": ("qwen3-1.7b", {"prefill_chunk": 48, "max_len": 100}, 1, "bursty", (90, 92),
                None),
    "fail-in-flight-dense": ("qwen3-1.7b", CHUNK, 2, "bursty", (30, 50), (0, 1)),
    "fail-in-flight-paged": ("qwen3-1.7b", {**CHUNK, **PAGED}, 2, "bursty", (30, 50), (1, 2)),
    "last-pair-dies": ("qwen3-1.7b", CHUNK, 1, "bursty", (30, 50), (0, 1)),
    "paged-over-max-len": ("qwen3-1.7b", {**CHUNK, **PAGED, "max_context": 192}, 1, "bursty",
                           (100, 121), None),
    "mamba2": ("mamba2-2.7b", CHUNK, 2, "bursty", (6, 50), None),
})


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_engine_matches_jax_engine(fp32_models, trace_factory, case):
    arch, econf, n_pairs, trace, (lo, hi), fail = CASES[case]
    jreqs = trace_factory(trace, n=4 if fail else 6, lo=lo, hi=hi)
    treqs = _copy(jreqs)
    jeng, teng = _engines(fp32_models(arch), n_pairs, **econf)
    failed = _serve_both(jeng, teng, jreqs, treqs, fail=fail)
    assert len(_records(teng)) == len(treqs)
    chunk = teng.pairs[0]._chunk
    assert chunk == (None if arch == "mamba2-2.7b" else 25 if case == "divisor" else 16)
    if chunk and econf.get("paged_kv"):  # chunked ingest is private: no prefix hit
        assert not any(r.cache_hit_tokens for r in treqs)
    if fail:  # chunk rows were in flight, and their requests were re-routed or failed
        assert failed[1] > 0
        if n_pairs == 1:
            assert {r.error for r in treqs} == {"no_healthy_workers"}
    if case == "paged-over-max-len":
        assert {r.error for r in treqs} == {"exceeds_max_context"}


def test_preemption_parks_the_long_prompt(fp32_model):
    """The long-prompt trace on one pair (chunk 8): an 80-token prompt, one
    tick, then 3 prompts of 12 tokens with a TTFT deadline.  Both engines
    agree with preemption on and off; with it on the long prompt's cursor
    is frozen while it is parked and the shorts' worst TTFT is lower; the
    tokens are those of the unchunked engine either way."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, fp32_model[0].vocab_size, n).tolist() for n in (80, 12, 12, 12)]
    trace = [JaxRequest(prompt=p, params=JaxSampling(max_new_tokens=6), arrival_time=float(i > 0),
                        slo_ttft=60.0 if i else None) for i, p in enumerate(prompts)]
    runs = {}
    for preempt in (True, False):
        jreqs, treqs = _copy(trace), _copy(trace)
        jeng, teng = _engines(fp32_model, 1, max_batch=4, prefill_chunk=8,
                              prefill_preempt=preempt)
        for eng, reqs in ((jeng, jreqs), (teng, treqs)):
            eng.submit(reqs[0])
            eng.step()
            cursor = eng.chunk_progress()[reqs[0].request_id]
            for req in reqs[1:]:
                eng.submit(req)
            eng.step()
            assert reqs[0].state.value == "prefilling"
            assert (eng.chunk_progress()[reqs[0].request_id] == cursor) == preempt
            eng.run_until_done()
        assert [r.output_tokens for r in treqs] == [r.output_tokens for r in jreqs]
        assert _records(teng) == _records(jeng)
        runs[preempt] = treqs
    worst = {k: max(r.token_times[0] - r.arrival_time for r in reqs[1:])
             for k, reqs in runs.items()}
    assert worst[True] < worst[False]
    _, plain = _engines(fp32_model, 1, max_batch=4)
    reqs = _copy(trace)
    _serve(plain, reqs)
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in runs[True]] \
        == [r.output_tokens for r in runs[False]]


@pytest.mark.parametrize("chunk", [None, 16, 25])
def test_estimator_chunk_pricing_matches_reference(chunk):
    cfg = reduced_config("qwen3-1.7b")
    theirs = JaxEstimator(cfg, hw=TPU_V5E, prefill_chunk=chunk)
    ours = PrefillDelayEstimator(cfg, hw=HardwareProfile(**dataclasses.asdict(TPU_V5E)),
                                 prefill_chunk=chunk)
    for n in (1, 8, 16, 17, 80, 400):
        assert ours.ticks(Request(prompt=list(range(n)))) == \
            theirs.ticks(JaxRequest(prompt=list(range(n))))
        for hit in (0, 8, 16, n - 1):
            assert ours.saved_ticks(n, hit) == theirs.saved_ticks(n, hit)
            assert ours.saved_frac(n, hit) == theirs.saved_frac(n, hit)


def _lockstep(model, n_pairs, prompt_lens, ops, **econf):
    """Submit one request per prompt length to both engines, step each once,
    run ``ops(engine, reqs)`` on each (its results must agree), drain, and
    hold the records equal.  Returns the port's engine, requests and result."""
    rng = np.random.default_rng(31)
    trace = [JaxRequest(prompt=rng.integers(0, model[0].vocab_size, n).tolist(),
                        params=JaxSampling(max_new_tokens=4)) for n in prompt_lens]
    out = []
    for eng, reqs in zip(_engines(model, n_pairs, prefill_chunk=8, **econf),
                         (trace, _copy(trace)), strict=True):
        for req in reqs:
            eng.submit(req)
        eng.step()
        out.append((eng, reqs, ops(eng, reqs)))
        eng.run_until_done()
    assert out[1][2] == out[0][2]
    assert _records(out[1][0]) == _records(out[0][0])
    return out[1]


def test_routing_sees_the_parked_backlog(fp32_model):
    """A request parked in a chunk row left the queue but owes the lane 7
    more chunks: queue depth and delay count it (and stop counting once it
    is done), as the JAX engine's do."""
    def signals(eng, reqs):
        sched = eng.scheduler
        return len(sched.prefill_queues[0]), sched.queue_depth(0), sched.queue_delay(0)

    eng, _, got = _lockstep(fp32_model, 1, [60], signals)
    assert got == (0, 1, 7.0)
    assert (eng.scheduler.queue_depth(0), eng.scheduler.queue_delay(0)) == (0, 0.0)


@pytest.mark.parametrize("econf", [{}, PAGED])
def test_cancel_and_warmup_mid_chunk(fp32_model, econf):
    """A parked request cancels cleanly (record, KV freed, cursor gone);
    warmup refuses while a chunk row is occupied, and counts the reference's
    programs on a fresh engine."""
    def cancel(eng, reqs):
        in_flight = eng.pairs[0].prefill_in_flight()
        with pytest.raises((AssertionError, RuntimeError), match="warmup"):
            eng.warmup()  # the reference asserts, the port raises
        ok = eng.cancel(reqs[0].request_id)
        return in_flight, ok, reqs[0].state.value, reqs[0].request_id in eng.pairs[0].kv.seqs

    eng, reqs, got = _lockstep(fp32_model, 1, [40, 20], cancel, **econf)
    assert got == (2, True, "cancelled", False)
    assert reqs[0].request_id not in eng.chunk_progress() and eng.drained()
    assert _records(eng)[0]["cancelled"]
    fresh = _engines(fp32_model, 1, prefill_chunk=8, **econf)
    assert fresh[1].warmup() == fresh[0].warmup()


def test_serve_config_chunk_validation_and_pending():
    cfg = ServeConfig.reduced_smoke(prefill_chunk=32, prefill_preempt=False)
    econf = cfg.build_engine_config()
    assert (econf.prefill_chunk, econf.prefill_preempt) == (32, False)
    for bad in (4, 128, "16", 16.0):  # < 8, > max_len (96), not an int
        with pytest.raises(ValueError, match="prefill_chunk"):
            ServeConfig.reduced_smoke(prefill_chunk=bad)
    serve = StreamServe(ServeConfig.reduced_smoke(prefill_chunk=16), device="cpu")
    handle = serve.submit(list(range(1, 61)))
    serve.step()
    assert handle.state is RequestState.PREFILLING and serve.pending == 1
    assert len(handle.result()) == serve.config.max_new_tokens and serve.pending == 0
