"""The port's Mamba2 (SSD) slice against the JAX package: the plain SSD scan
against the Pallas kernel (interpret mode), the decode recurrence, the
layer, the model with speculative rollback, and the fp32 engine serving the
reduced mamba2-2.7b token- and record-identically.

The same numpy inputs (and, through the weight bridge, the same weights) go
to both frameworks.  Tolerances: 1e-4 in float32, the reference's own for
SSD (tests/test_kernels.py); 2e-2 on bf16 logits.  The CUDA kernel has no
CPU mode: ``chip_smoke.py`` holds it to the plain version on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import SSD_CASES
from test_torch_engine import _serve

import repro.core.engine as jax_engine
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.distributed.sharding import unzip_params
from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import build_model as jax_build
from repro.models import ssm as jax_ssm
from repro.serving.cost_model import TPU_V5E
from repro.serving.cost_model import PrefillDelayEstimator as JaxEstimator
from repro_torch.configs import ArchConfig, SSMConfig, get_config, reduced_config
from repro_torch.core.engine import EngineConfig, PipeServeEngine
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.models import build_model
from repro_torch.models import ssm
from repro_torch.params import from_jax_tree
from repro_torch.serving.cost_model import HardwareProfile, PrefillDelayEstimator
from repro_torch.serving.request import Request, SamplingParams

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ARCH = "mamba2-2.7b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need one intra-op thread; the suite's other workers get
    the rest of the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(rng, B, S, H, P, G, N, init):
    """The reference test's distributions (tests/test_kernels.py), as numpy."""
    arrays = [rng.normal(size=(B, S, H, P)) * 0.5, rng.uniform(0.001, 0.1, (B, S, H)),
              -rng.uniform(0.5, 4.0, (H,)), rng.normal(size=(B, S, G, N)) * 0.3,
              rng.normal(size=(B, S, G, N)) * 0.3]
    if init:
        arrays.append(rng.normal(size=(B, H, P, N)) * 0.2)
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("case", SSD_CASES + [(2, 5, 4, 16, 1, 16, 256, True),
                                              (1, 300, 4, 16, 2, 32, 256, True)])
def test_ssd_plain_matches_pallas(case):
    """Every row of the reference's table, a prompt shorter than 8 and a
    ragged tail behind a full 256-row chunk: output and final state."""
    B, S, H, P, G, N, chunk, init = case
    arrays = _ssd_inputs(np.random.default_rng(S), B, S, H, P, G, N, init)
    want_y, want_s = ssd_scan_pallas(*map(jnp.asarray, arrays[:5]), chunk=chunk,
                                     initial_state=jnp.asarray(arrays[5]) if init else None,
                                     return_state=True, interpret=True)
    t = [torch.from_numpy(a) for a in arrays]
    y, s = ops.ssd_scan(*t[:5], chunk=chunk, initial_state=t[5] if init else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-4)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(1)
    x, dt, A, Bm, C, s0 = _ssd_inputs(rng, 2, 1, 8, 16, 2, 16, True)
    args = (s0, x[:, 0], dt[:, 0], A, Bm[:, 0], C[:, 0])
    want = jax_ref.ssd_decode_step(*map(jnp.asarray, args))
    out = torch.empty(s0.shape)
    got = ops.ssd_decode_step(*map(torch.from_numpy, args), out=out)
    assert got[0].data_ptr() == out.data_ptr()
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_ssd_cuda_wrapper_refuses_cpu_tensors():
    arrays = [torch.from_numpy(a) for a in _ssd_inputs(np.random.default_rng(2),
                                                       1, 8, 2, 16, 1, 16, False)]
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan_cuda(*arrays)
    assert ssd_scan_cuda.launches == before


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dt = request.param
    jcfg = dataclasses.replace(jax_reduced(ARCH), n_layers=2, dtype=dt)
    tcfg = dataclasses.replace(reduced_config(ARCH), n_layers=2, dtype=dt)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = jax_build(jcfg)
    jparams, _ = unzip_params(jm.init(jax.random.PRNGKey(0)))
    tparams = from_jax_tree(jax.tree.map(np.asarray, jparams), tcfg, dtype=getattr(torch, dt))
    return dt, jcfg, jm, jparams, build_model(tcfg, "cpu"), tparams


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


def test_mamba_layer_prefill_and_decode_match_reference(models):
    """One layer: the prefill cache (conv window, state) and a T=4 decode
    (output, per-token states and windows) in fp32; the bf16 model is held
    on its logits below.  A_log, D and dt_bias stay fp32 in either dtype."""
    dt, jcfg, _, jparams, tm, tparams = models
    p = tparams["layers"][0]["mamba"]
    assert all(p[k].dtype == torch.float32 for k in ("A_log", "D", "dt_bias"))
    if dt != "float32":
        return
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["0"]["mamba"])
    h = np.random.default_rng(3).normal(size=(2, 37, jcfg.d_model)).astype(np.float32)
    jout, jc = jax_ssm.mamba_prefill(jp, jcfg, jnp.asarray(h[:, :33]))
    out, (conv, state) = ssm.mamba_prefill(p, tm.cfg, torch.from_numpy(h[:, :33]))
    for got, want in ((out, jout), (conv, jc["conv"]), (state, jc["state"])):
        _close(got, want, dt)
    jout, jc = jax_ssm.mamba_decode(jp, jcfg, jnp.asarray(h[:, 33:]), jc)
    cache = ssm.init_mamba_cache(tm.cfg, 1, 2, torch.float32, "cpu", steps=4)
    cache = {k: v[0] for k, v in cache.items()}
    cache["conv"].copy_(conv)
    cache["state"].copy_(state)
    _close(ssm.mamba_decode(p, tm.cfg, torch.from_numpy(h[:, 33:]), cache), jout, dt)
    for k in ("conv", "state", "states_all", "conv_all"):
        _close(cache[k], jc[k], dt)


def test_model_prefill_verify_commit_matches_reference(models):
    """Prefill, a T=4 verify, a per-row commit and a plain step: logits of
    every step (and, in fp32, the committed SSM state) match the JAX model."""
    dt, _, jm, jp, tm, tp = models
    rng = np.random.default_rng(4)
    toks, step, probe = (rng.integers(0, tm.cfg.vocab_size, (2, n)).astype(np.int32)
                         for n in (40, 4, 1))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=64)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 64)
    _close(tl, jl, dt)
    old = jc["len"]
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(step))
    _close(tm.decode_step(tp, tc, torch.from_numpy(step)), jl, dt)
    accept = np.array([1, 3], np.int32)
    jc = jm.commit_cache(jc, old, jnp.asarray(accept))
    tm.commit_cache(tc, tc["len"] - 4, torch.from_numpy(accept))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    if dt == "float32":
        _close(tc["state"][0], jc["blocks"]["0"]["state"][0], dt)
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(probe))
    _close(tm.decode_step(tp, tc, torch.from_numpy(probe)), jl, dt)


def test_rollback_commit_equals_never_seeing_rejected_tokens(models):
    """Decode [good, junk] (T=4) and commit the 2 good tokens: the next step
    equals a run that only ever saw the good ones (tests/test_models_smoke.py)."""
    dt, *_, tm, tp = models
    rng = np.random.default_rng(5)
    prompt, good, junk, probe = (torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, (1, n))
                                                  .astype(np.int32)) for n in (8, 2, 2, 1))
    _, cache = tm.prefill(tp, {"tokens": prompt}, 64)
    tm.decode_step(tp, cache, torch.cat([good, junk], 1))
    tm.commit_cache(cache, cache["len"] - 4, torch.tensor([1], dtype=torch.int32))
    la = tm.decode_step(tp, cache, probe)
    _, cache_b = tm.prefill(tp, {"tokens": prompt}, 64)
    tm.decode_step(tp, cache_b, good)
    _close(la, tm.decode_step(tp, cache_b, probe), dt)


@pytest.mark.parametrize("n", [2, 6])
def test_prefill_equals_decoding_from_an_empty_cache(models, n):
    """A prompt shorter than the conv window (where the JAX package's insert
    fails on the short window) and a longer one: prefill gives the logits
    and state of decoding the prompt from a zeroed cache."""
    dt, *_, tm, tp = models
    prompt = torch.from_numpy(np.random.default_rng(n).integers(0, tm.cfg.vocab_size, (2, n))
                              .astype(np.int32))
    logits, cache = tm.prefill(tp, {"tokens": prompt}, 64)
    empty = tm.init_cache(2, 64, steps=n)
    _close(logits, tm.decode_step(tp, empty, prompt)[:, -1], dt)
    _close(cache["conv"], empty["conv"].float(), dt)


@pytest.fixture(scope="module")
def fp32_mamba():
    jcfg = dataclasses.replace(jax_reduced(ARCH), n_layers=2, dtype="float32")
    tcfg = dataclasses.replace(reduced_config(ARCH), n_layers=2, dtype="float32")
    jparams, _ = unzip_params(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, jparams, tcfg, from_jax_tree(jax.tree.map(np.asarray, jparams), tcfg)


@pytest.mark.parametrize("trace", ["bursty", "uniform", "mixed_slo"])
def test_engine_matches_jax_engine(fp32_mamba, trace_factory, trace):
    """Exact-shape admission (one per call), verify with per-token states and
    rollback, on 2 pairs: the same tokens, routing and RequestRecords."""
    jcfg, jparams, tcfg, tparams = fp32_mamba
    kw = {"max_batch": 2, "max_len": 96}
    jreqs = trace_factory(trace, n=6)
    treqs = [Request(prompt=list(r.prompt), request_id=r.request_id,
                     params=SamplingParams(max_new_tokens=r.params.max_new_tokens),
                     arrival_time=r.arrival_time, slo_ttft=r.slo_ttft, slo_tpot=r.slo_tpot)
             for r in jreqs]
    jeng = jax_engine.PipeServeEngine(jcfg, jparams, n_pairs=2,
                                      econf=jax_engine.EngineConfig(**kw))
    teng = PipeServeEngine(tcfg, tparams, n_pairs=2, econf=EngineConfig(**kw), device="cpu",
                           hardware=HardwareProfile(**dataclasses.asdict(TPU_V5E)))
    assert [p.admit_cap() for p in teng.pairs] == [1, 1]
    if trace == "bursty":  # no prefill program: the verify buckets and the plain step
        assert teng.warmup() == jeng.warmup() == 2 * (len(EngineConfig().verify_buckets) + 1)
    _serve(jeng, jreqs)
    _serve(teng, treqs)
    assert [r.output_tokens for r in treqs] == [r.output_tokens for r in jreqs]
    assert [r.worker_id for r in treqs] == [r.worker_id for r in jreqs]
    assert [dataclasses.asdict(r) for r in teng.monitor.completed] == \
        [dataclasses.asdict(r) for r in jeng.monitor.completed]
    assert sum(p.lane.calls["prefill"] for p in teng.pairs) == \
        sum(r.generated > 0 for r in teng.monitor.completed)


def test_param_count_and_prefill_pricing_match_reference():
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    assert tcfg.n_active_params() == jcfg.n_active_params()
    jest = JaxEstimator(jcfg, hw=TPU_V5E, max_batch=8, mean_context=256)
    test = PrefillDelayEstimator(tcfg, hw=HardwareProfile(**dataclasses.asdict(TPU_V5E)),
                                 max_batch=8, mean_context=256)
    for n in (16, 400, 4000):
        req = Request(prompt=list(range(n)))
        assert test.ticks(req) == jest.ticks(Request(prompt=list(range(n))))


def test_paged_ssm_and_moe_are_refused(fp32_mamba):
    with pytest.raises(ValueError, match="attention-only"):
        PipeServeEngine(*fp32_mamba[2:], n_pairs=1, device="cpu",
                        econf=EngineConfig(max_batch=2, max_len=96, paged_kv=True))
    jamba = jax_get_config("jamba-1.5-large-398b")
    fields = {f.name: getattr(jamba, f.name) for f in dataclasses.fields(ArchConfig)}
    fields["ssm"] = SSMConfig(**dataclasses.asdict(jamba.ssm))
    with pytest.raises(NotImplementedError, match="MoE"):
        build_model(ArchConfig(**fields), "cpu")
