"""The port's serving stack against the JAX engine, and its entry points.

Parity runs in float32 (``dataclasses.replace(cfg, dtype="float32")``),
where greedy tokens can be held identical: the same weights (through the
weight bridge), the same canned trace and 2 stream pairs must give the same
tokens, the same ``worker_id`` for every request and equal RequestRecords.
Routing prices prefill with the reference's TPU profile so both estimators
see the same numbers.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jax_serve
import repro.api.config as jax_api
import repro.core.engine as jax_engine
from repro.configs import reduced_config as jax_reduced
from repro.distributed.sharding import unzip_params
from repro.models import build_model as jax_build
from repro.serving.cost_model import TPU_V5E
from repro.serving.speculative import verify_tokens as jax_verify
from repro_torch.api import ServeConfig, StreamServe
from repro_torch.configs import FrontendConfig, reduced_config
from repro_torch.core.engine import EngineConfig, PipeServeEngine
from repro_torch.launch.train import main as train_main
from repro_torch.params import from_jax_tree
from repro_torch.serving.cost_model import HardwareProfile
from repro_torch.serving.request import Request, RequestState, SamplingParams
from repro_torch.serving.speculative import verify_tokens

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need one intra-op thread; the suite's other workers get
    the rest of the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nonzero_biases(tree, seed=5):
    """A numpy parameter tree with every QKV bias (``bq``, ``bk``, ``bv``;
    zeros from the init, which would prove nothing) set to N(0, 0.5) values,
    in place."""
    rng = np.random.default_rng(seed)
    for k, v in tree.items():
        if isinstance(v, dict):
            nonzero_biases(v, rng)
        elif k in ("bq", "bk", "bv"):
            tree[k] = (0.5 * rng.normal(size=v.shape)).astype(v.dtype)
    return tree


def fp32_pair(arch, seed=0, **fields):
    """The reference's and the port's reduced ``arch``, 2 layers in float32
    (and any other ``fields``), with the same weights from the reference's
    init at ``seed``, QKV biases nonzero: (jcfg, jparams, tcfg, tparams)."""
    fields = {"n_layers": 2, "dtype": "float32", **fields}
    jcfg = dataclasses.replace(jax_reduced(arch), **fields)
    tcfg = dataclasses.replace(reduced_config(arch), **fields)
    jparams, _ = unzip_params(jax_build(jcfg).init(jax.random.PRNGKey(seed)))
    tree = nonzero_biases(jax.tree.map(np.asarray, jparams))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, from_jax_tree(tree, tcfg)


@pytest.fixture(scope="module")
def fp32_model():
    return fp32_pair("qwen3-1.7b")


@pytest.fixture(scope="module")
def fp32_models(fp32_model):
    """fp32_pair by (arch, sliding window), each built once."""
    made = {("qwen3-1.7b", None): fp32_model}

    def get(arch="qwen3-1.7b", window=None):  # window None: the arch's own
        if (arch, window) not in made:
            made[arch, window] = fp32_pair(arch, **({"sliding_window": window} if window else {}))
        return made[arch, window]
    return get


def _engines(pair, n_pairs, draft_model=(None,) * 4, **kw):
    """The JAX engine and the port's on the same weights (and the same
    ``draft_model``, an fp32_pair, for draft='model'); routing prices prefill
    with the reference's TPU profile."""
    jcfg, jparams, tcfg, tparams = pair
    kw = {"max_batch": 2, "max_len": 96, **kw}
    return (jax_engine.PipeServeEngine(jcfg, jparams, n_pairs=n_pairs,
                                       econf=jax_engine.EngineConfig(**kw),
                                       draft_cfg=draft_model[0], draft_params=draft_model[1]),
            PipeServeEngine(tcfg, tparams, n_pairs=n_pairs, econf=EngineConfig(**kw),
                            draft_cfg=draft_model[2], draft_params=draft_model[3], device="cpu",
                            hardware=HardwareProfile(**dataclasses.asdict(TPU_V5E))))


def _copy(reqs):
    return [Request(prompt=list(r.prompt), request_id=r.request_id,
                    params=SamplingParams(max_new_tokens=r.params.max_new_tokens),
                    arrival_time=r.arrival_time, slo_ttft=r.slo_ttft, slo_tpot=r.slo_tpot)
            for r in reqs]


def _records(engine):
    return [dataclasses.asdict(r) for r in engine.monitor.completed]


def _serve(engine, reqs, max_steps=600, fail=None, cancel=None, drain=True):
    """Submit each request once the engine clock reaches its arrival time
    (all at once for traces without one), then drain (``drain=False``: take
    ``max_steps`` steps).  With ``fail`` = (pair, tick) that pair fails once
    the clock reaches the tick, and with ``cancel`` = (index, tick) that
    request is cancelled then; returns how many requests the failure
    re-routed and how many were in its chunk rows."""
    queue, failed = list(reqs), None
    for _ in range(max_steps):
        while queue and (queue[0].arrival_time if queue[0].arrival_time is not None
                         else 0.0) <= engine._now:
            engine.submit(queue.pop(0))
        if fail and failed is None and engine._now >= fail[1]:
            in_flight = engine.pairs[fail[0]].prefill_in_flight()
            failed = engine.fail_worker(fail[0]), in_flight
        if cancel and engine._now == cancel[1]:
            assert engine.cancel(reqs[cancel[0]].request_id)
        if drain and not queue and engine.drained():
            return failed
        engine.step()
    if drain:
        raise AssertionError("engine did not drain")
    return failed


def _serve_both(jeng, teng, jreqs, treqs, fail=None):
    """Serve a trace on the JAX engine and its copy on the port's: the same
    tokens, pair, errors and prefix hits for every request, the same
    RequestRecords and chunk size, and (``fail``) the same re-routing.
    Returns what ``_serve`` returned."""
    failed = _serve(jeng, jreqs, fail=fail)
    assert _serve(teng, treqs, fail=fail) == failed
    for field in ("output_tokens", "worker_id", "error", "cache_hit_tokens"):
        assert [getattr(r, field) for r in treqs] == [getattr(r, field) for r in jreqs], field
    assert _records(teng) == _records(jeng)
    assert [p._chunk for p in teng.pairs] == [p._chunk for p in jeng.pairs]
    return failed


def _refused(wrapper, *args):
    """A CUDA wrapper given CPU tensors raises and counts no launch."""
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(*args)
    assert wrapper.launches == before


TRACES = ("bursty", "uniform", "mixed_slo")
PAGED = {"paged_kv": True, "kv_blocks": 256, "kv_block_size": 16}
# case -> (sliding window, engine overrides, trace, its prompt lengths,
# (pair, tick) that fails or None).  The plain traces; a pair failing early
# or late, dense and paged; a dense sliding-window ring (capacity 48 and 72)
# under prompts that wrap it, one-shot and chunked
ENGINE_CASES = {t: (None, {}, t, (6, 50), None) for t in TRACES}
ENGINE_CASES.update({f"fail{w}@{tick}-{kv}-{t}": (None, PAGED if kv == "paged" else {}, t, (6, 50),
                                                  (w, tick))
                     for kv in ("dense", "paged") for w, tick in ((0, 2), (1, 4)) for t in TRACES})
ENGINE_CASES.update({f"window{w}-{c}-{t}": (w, {"prefill_chunk": 16} if c == "chunked" else {},
                                            t, (30, 89), None)
                     for w in (16, 40) for c in ("oneshot", "chunked") for t in TRACES})


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax_engine(fp32_models, trace_factory, case):
    window, econf, trace, (lo, hi), fail = ENGINE_CASES[case]
    jreqs = trace_factory(trace, n=6, lo=lo, hi=hi)
    treqs = _copy(jreqs)
    jeng, teng = _engines(fp32_models(window=window), 2, **econf)
    failed = _serve_both(jeng, teng, jreqs, treqs, fail=fail)
    assert len(teng.monitor.completed) == len(treqs)
    if fail:  # the dead pair's requests were re-routed and finished on the other
        assert failed[0] > 0 and all(r.worker_id != fail[0] for r in teng.monitor.completed
                                     if r.t_end > fail[1])
    else:
        assert {r.worker_id for r in treqs} == {0, 1}
    if window:  # the ring wrapped: some prompt outgrew its capacity
        assert max(len(r.prompt) for r in treqs) > teng.pairs[0].lane.cache["k"].shape[2]


# the M9 dense models, reduced: qwen2.5-14b (QKV bias), starcoder2-7b (GELU,
# paged) and h2o-danube-3-4b (its window of 16, a ring of 48 slots that
# prompts of 30-89 tokens wrap, one-shot and chunked): (arch, engine
# overrides, trace, prompt lengths)
M9_ENGINE_CASES = {
    "qwen2.5-14b": ("qwen2.5-14b", {}, "mixed_slo", (6, 50)),
    "starcoder2-7b-paged": ("starcoder2-7b", PAGED, "bursty", (6, 50)),
    "h2o-danube-3-4b-ring": ("h2o-danube-3-4b", {}, "uniform", (30, 89)),
    "h2o-danube-3-4b-ring-chunked": ("h2o-danube-3-4b", {"prefill_chunk": 16}, "bursty",
                                     (30, 89)),
}


@pytest.mark.parametrize("case", list(M9_ENGINE_CASES))
def test_m9_engine_matches_jax_engine(fp32_models, trace_factory, case):
    arch, econf, trace, (lo, hi) = M9_ENGINE_CASES[case]
    jreqs = trace_factory(trace, n=6, lo=lo, hi=hi)
    treqs = _copy(jreqs)
    pair = fp32_models(arch)
    jeng, teng = _engines(pair, 2, **econf)
    _serve_both(jeng, teng, jreqs, treqs)
    assert len(teng.monitor.completed) == len(treqs)
    if pair[2].sliding_window:  # the ring wrapped
        assert max(len(r.prompt) for r in treqs) > teng.pairs[0].lane.cache["k"].shape[2]


def test_padded_heads_through_streamserve_match_the_jax_engine(trace_factory):
    """A config whose query heads the reference pads (qwen2.5's bias, 20
    heads over 4 KV heads: G 5 -> 8) served through both packages'
    StreamServe(arch_cfg=...), the port on the unpadded heads."""
    jcfg, jparams, tcfg, tparams = fp32_pair("qwen2.5-14b", n_heads=20, n_kv_heads=4)
    assert jcfg.padded_heads == 32
    kw = {"arch": "qwen2.5-14b", "max_new_tokens": 8}
    jserve = jax_serve.StreamServe(jax_serve.ServeConfig.reduced_smoke(**kw), params=jparams,
                                   arch_cfg=jcfg)
    tserve = StreamServe(ServeConfig.reduced_smoke(**kw), params=tparams, arch_cfg=tcfg,
                         device="cpu")
    jreqs = trace_factory("bursty", n=6)
    treqs = _copy(jreqs)
    _serve_both(jserve.engine, tserve.engine, jreqs, treqs)
    assert len(tserve.monitor.completed) == len(treqs)


def test_verify_tokens_matches_jax_greedy_per_row_depth():
    rng = np.random.default_rng(7)
    B, k, V = 5, 4, 64
    logits = rng.normal(size=(B, k + 1, V)).astype(np.float32)
    draft = rng.integers(0, V, (B, k)).astype(np.int32)
    draft[:3, :3] = logits[:3, :3].argmax(-1)  # prefixes the target accepts
    args = (draft, np.ones((B, k), np.float32), logits)
    kw = {"active": np.array([True] * 4 + [False]), "depth": np.array([4, 2, 1, 3, 0], np.int32)}
    want = jax_verify(jax.random.PRNGKey(0), *map(jnp.asarray, args),
                      **{n: jnp.asarray(a) for n, a in kw.items()})
    got = verify_tokens(torch.Generator().manual_seed(0), *map(torch.from_numpy, args),
                        **{n: torch.from_numpy(a) for n, a in kw.items()})
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.n_accepted.tolist()[:4] == [3, 2, 1, 0]


def test_serve_config_has_the_reference_fields_and_defaults():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(ServeConfig) == fields(jax_api.ServeConfig)
    assert fields(EngineConfig) == fields(jax_engine.EngineConfig)


def test_streamserve_submit_stream_cancel_on_cpu():
    serve = StreamServe(ServeConfig.reduced_smoke(), device="cpu")
    rng = np.random.default_rng(0)
    handles = [serve.submit(rng.integers(0, serve.arch.vocab_size, 10).tolist())
               for _ in range(3)]
    serve.step()
    assert handles[2].state is RequestState.DECODING
    assert handles[2].cancel() and handles[2].cancelled and not handles[2].cancel()
    streamed = list(handles[0].stream())
    assert len(streamed) == serve.config.max_new_tokens
    assert handles[0].state is RequestState.FINISHED
    assert handles[1].result() and handles[1].state is RequestState.FINISHED
    assert serve.pending == 0 and serve.summary()["cancelled"] == 1
    slo = handles[0].slo()
    assert slo["n_tokens"] == len(streamed) and slo["ttft"] is not None
    with pytest.raises(ValueError):
        serve.submit([])


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch, fp32_model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for config in (ServeConfig.reduced_smoke(), ServeConfig.reduced_smoke(paged_kv=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamServe(config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PipeServeEngine(*fp32_model[2:], n_pairs=1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_main(["--steps", "1"])


@pytest.mark.parametrize("overrides, item", [
    ({"frontend": FrontendConfig(kind="vision", n_tokens=8)}, r"§3 item 10\)"),
    ({"n_encoder_layers": 2}, r"§3 item 10\)")])
def test_later_slices_refuse_by_name(fp32_model, overrides, item):
    """What the engine does not serve (a request carries no patches or
    frames) refuses, naming its ROADMAP item."""
    with pytest.raises(NotImplementedError, match=item):
        PipeServeEngine(dataclasses.replace(fp32_model[2], **overrides), fp32_model[3],
                        n_pairs=1, device="cpu", econf=EngineConfig(max_batch=2, max_len=96))


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port, chip_smoke.py, attention_variants.py and the
    ``examples/*_torch.py`` import in a fresh process without loading jax,
    any module of ``repro`` or ``tools``, or PyYAML (the card's machine has
    none)."""
    code = ("import importlib, pkgutil, sys, repro_torch, chip_smoke, attention_variants\n"
            "import quickstart_torch, train_resilient_torch, serve_cluster_torch\n"
            "import spec_depth_study_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro', 'tools',\n"
            "                                                  'yaml')]\n"
            "sys.exit(f'loaded {bad}' if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ,
                               "PYTHONPATH": f"{REPO / 'src'}:{REPO}:{REPO / 'examples'}"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
