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
from test_torch_engine import _copy, _engines, _records, _refused, _serve_both, fp32_pair
from test_torch_engine import _one_torch_thread  # noqa: F401
from test_torch_model import _close, model_pair
from test_torch_paged import _bf16

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jax_ssm
from repro.serving.cost_model import TPU_V5E
from repro.serving.cost_model import PrefillDelayEstimator as JaxEstimator
from repro_torch.configs import ArchConfig, SSMConfig, get_config
from repro_torch.core.engine import EngineConfig, PipeServeEngine
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.models import build_model
from repro_torch.models import ssm
from repro_torch.serving.cost_model import HardwareProfile, PrefillDelayEstimator
from repro_torch.serving.request import Request

ARCH = "mamba2-2.7b"


def _ssd_inputs(rng, B, S, H, P, G, N, init):
    """The reference test's distributions (tests/test_kernels.py), as numpy."""
    arrays = [rng.normal(size=(B, S, H, P)) * 0.5, rng.uniform(0.001, 0.1, (B, S, H)),
              -rng.uniform(0.5, 4.0, (H,)), rng.normal(size=(B, S, G, N)) * 0.3,
              rng.normal(size=(B, S, G, N)) * 0.3]
    if init:
        arrays.append(rng.normal(size=(B, H, P, N)) * 0.2)
    return [a.astype(np.float32) for a in arrays]


def _ssd_refs(arrays, chunk=256):
    """The reference's Pallas kernel (interpret mode), its plain version and
    the port's plain version on the numpy inputs (and initial state, when
    given): three (y, final state)."""
    jx, tx = [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]
    kw = {"chunk": chunk, "initial_state": jx[5] if len(jx) > 5 else None, "return_state": True}
    return (ssd_scan_pallas(*jx[:5], interpret=True, **kw), jax_ref.ssd_scan(*jx[:5], **kw),
            ops.ssd_scan(*tx[:5], chunk=chunk, initial_state=tx[5] if len(tx) > 5 else None))


@pytest.mark.parametrize("case", SSD_CASES + [(2, 5, 4, 16, 1, 16, 256, True),
                                              (1, 300, 4, 16, 2, 32, 256, True)])
def test_ssd_plain_matches_pallas(case):
    """Every row of the reference's table, a prompt shorter than 8 and a
    ragged tail behind a full 256-row chunk: output and final state."""
    B, S, H, P, G, N, chunk, init = case
    (want_y, want_s), _, (y, s) = _ssd_refs(
        _ssd_inputs(np.random.default_rng(S), B, S, H, P, G, N, init), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-4)


def _ssd_walk(rnd, x, dt, A, Bm, C, s0=None, wrong=False):
    """ssd_wgmma_kernel's schedule in numpy (fp32): 64-row chunks, cut into
    spans of ceil(nc / min(nc, 8)), a block each.  Phase A: each span's update
    U from a zero state (U = exp(cs_last) U + rnd(x o w)^T B) and its decay D,
    U published through rnd.  The combine walks the spans in order from the
    initial state, S = S D + U (``wrong``: (S + U) D, a span's decay on its own
    update); rnd(S) enters the span, what leaves the last is the final state.
    Phase B: y = rnd(scores) x + rnd(C o exp(cs)) rnd(S)^T a chunk, the state
    stepping on in fp32 between a span's chunks.  rnd rounds to bf16 where the
    kernel does, or is the identity (fp32)."""
    Bsz, S, H, P = x.shape
    nc = -(-S // 64)
    span = -(-nc // min(nc, 8))
    x, dt, Bm, C = (np.pad(a, [(0, 0), (0, nc * 64 - S)] + [(0, 0)] * (a.ndim - 2))
                    .reshape(Bsz, nc, 64, *a.shape[2:]) for a in (x, dt, Bm, C))
    Bm, C = (a.repeat(H // a.shape[3], 3) for a in (Bm, C))
    cs = np.cumsum(dt * A, axis=2)
    seg = np.where(np.tri(64, dtype=bool)[..., None], cs[:, :, :, None] - cs[:, :, None], -np.inf)
    scores = np.einsum("bcihn,bcjhn->bcijh", C, Bm) * np.exp(seg) * dt[:, :, None]
    y = np.einsum("bcijh,bcjhp->bcihp", rnd(scores), x)
    upd = np.einsum("bcjhp,bcjhn->bchpn", rnd(x * (np.exp(cs[:, :, -1:] - cs) * dt)[..., None]),
                    Bm)
    L, s, st_in = np.exp(cs[:, :, -1])[..., None, None], 0 * upd[:, 0] if s0 is None else s0, []
    for k in range(0, nc, span):
        st, u = rnd(s), 0
        for c in range(k, min(nc, k + span)):
            st_in.append(rnd(st))
            st, u = L[:, c] * st + upd[:, c], L[:, c] * u + upd[:, c]
        d = np.exp(cs[:, k:k + span, -1].sum(1))[..., None, None]
        s = (s + rnd(u)) * d if wrong else s * d + rnd(u)
    y += np.einsum("bcihn,bchpn->bcihp", rnd(C * np.exp(cs)[..., None]), np.stack(st_in, 1))
    return rnd(y.reshape(Bsz, nc * 64, H, P)[:, :S]), s


# B, S, H, P, G, N, initial state: one chunk and less, one chunk and one row
# (two blocks), 5 blocks over a ragged tail, 2 and 4 chunks a block
SCHEDULE_CASES = {"S5": (2, 5, 2, 16, 1, 32, False), "S64": (1, 64, 2, 16, 1, 32, True),
                  "S65": (1, 65, 2, 16, 1, 32, False), "S300": (2, 300, 4, 16, 2, 32, True),
                  "S1000": (1, 1000, 2, 16, 1, 32, False), "S2048": (1, 2048, 2, 16, 1, 32, True)}


@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_chunk_parallel_schedule_matches_pallas(case):
    """The bf16 K4 kernel's chunk-parallel schedule and combine, walked in
    numpy on inputs rounded to bf16, against the reference's Pallas kernel
    (interpret mode), its plain version and the port's plain version: within
    2e-2 with the kernel's bf16 roundings, 1e-4 without.  A combine that puts
    each span's decay on its own update fails."""
    arrays = _ssd_inputs(np.random.default_rng(SCHEDULE_CASES[case][1]), *SCHEDULE_CASES[case])
    for i in (0, 3, 4):
        arrays[i] = _bf16(arrays[i])
    wants = _ssd_refs(arrays)

    def check(got, tol):
        for want in wants:
            for g, w in zip(got, want, strict=True):
                np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol)

    check(_ssd_walk(_bf16, *arrays), 2e-2)
    check(_ssd_walk(lambda a: a, *arrays), 1e-4)
    with pytest.raises(AssertionError):
        check(_ssd_walk(_bf16, *arrays, wrong=True), 2e-2)


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
    _refused(ssd_scan_cuda, *map(torch.from_numpy, _ssd_inputs(np.random.default_rng(2),
                                                                1, 8, 2, 16, 1, 16, False)))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    return model_pair(ARCH, request.param)


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
    return fp32_pair(ARCH)


@pytest.mark.parametrize("trace", ["bursty", "uniform", "mixed_slo"])
def test_engine_matches_jax_engine(fp32_mamba, trace_factory, trace):
    """Exact-shape admission (one per call), verify with per-token states and
    rollback, on 2 pairs: the same tokens, routing and RequestRecords."""
    jreqs = trace_factory(trace, n=6)
    treqs = _copy(jreqs)
    jeng, teng = _engines(fp32_mamba, 2)
    assert [p.admit_cap() for p in teng.pairs] == [1, 1]
    if trace == "bursty":  # no prefill program: the verify buckets and the plain step
        assert teng.warmup() == jeng.warmup() == 2 * (len(EngineConfig().verify_buckets) + 1)
    _serve_both(jeng, teng, jreqs, treqs)
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
