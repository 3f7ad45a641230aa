"""The port's paged KV path against the JAX package: the plain paged decode
attention (K3's oracle) against the reference's plain version and its Pallas
kernel (interpret mode), the serve-mode KVCacheManager operation by
operation, and the fp32 paged engine token- and record-identical to the JAX
paged engine.  Tolerances are the reference's own: 2e-5 in float32, 2e-2 in
bfloat16 (``tests/test_kernels.py:19``).  The CUDA kernel has no CPU mode:
``chip_smoke.py`` holds it to the plain version on the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _one_torch_thread, _serve, fp32_model  # noqa: F401

import repro.core.engine as jax_engine
from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import decode_attention_paged_pallas
from repro.serving import kv_cache as jax_kv
from repro.serving.cost_model import TPU_V5E
from repro_torch.api import ServeConfig, StreamServe
from repro_torch.core.engine import EngineConfig, PipeServeEngine
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_paged_cuda
from repro_torch.serving import kv_cache
from repro_torch.serving.cost_model import HardwareProfile
from repro_torch.serving.request import Request, SamplingParams

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


# (T, dtype, window): decode and verify sizes, an admission-sized T, bf16
@pytest.mark.parametrize("T, dt, window", [(1, "float32", None), (3, "float32", None),
                                           (9, "float32", 7), (32, "float32", None),
                                           (3, "bfloat16", None), (32, "bfloat16", None)])
def test_paged_plain_matches_reference_and_pallas(T, dt, window):
    """Shuffled non-contiguous pages, ragged -1 tails, a cache_len that ends
    mid-page and a row whose table is all -1 (its output is finite)."""
    rng = np.random.default_rng(T)
    B, P, ps, K, D, n_pages = 4, 4, 16, 2, 32, 24
    clen = np.array([T + 5, P * ps, T + 21, T + 2], np.int32)
    bt = np.full((B, P), -1, np.int32)
    ids = rng.permutation(n_pages)
    for b in range(B - 1):
        n = -(-int(clen[b]) // ps)
        bt[b, :n], ids = ids[:n], ids[n:]
    shapes = [(B, T, 2 * K, D), (n_pages, ps, K, D), (n_pages, ps, K, D)]
    jx = [jnp.asarray(rng.normal(size=s), dt) for s in shapes]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dt)) for a in jx]
    got = ops.decode_attention_paged(*tx, torch.from_numpy(clen), torch.from_numpy(bt),
                                     window=window)
    assert torch.isfinite(got).all()
    args = (*jx, jnp.asarray(clen), jnp.asarray(bt))
    for want in (jax_ref.decode_attention_paged(*args, window=window),
                 decode_attention_paged_pallas(*args, window=window, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=TOL[dt], rtol=TOL[dt])


def test_paged_cuda_wrapper_refuses_cpu_tensors():
    before = decode_attention_paged_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        decode_attention_paged_cuda(torch.zeros(1, 2, 4, 32), torch.zeros(4, 16, 2, 32),
                                    torch.zeros(4, 16, 2, 32), torch.tensor([2], dtype=torch.int32),
                                    torch.zeros(1, 2, dtype=torch.int32))
    assert decode_attention_paged_cuda.launches == before


def _admission_walk(q, kp, vp, clen, bt, window):
    """paged_prefill_kernel's schedule in numpy: per (row, KV head), 64-row
    query tiles r = t*G + g; each tile walks 64-position KV tiles over its
    rows' range [lo, hi] (hi clamped to P*ps - 1), gathering each position's
    slot from the table (clamped; -1 outside the range or unset: masked and
    read as zeros); base-2 online softmax with the -1e30 sentinel; P rounded
    to bf16 before P.V; a row that saw nothing gets the mean of V over every
    table entry, an unset entry read as page 0."""
    B, T, H, D = q.shape
    n_pages, ps, K, _ = kp.shape
    P, G, c = bt.shape[1], H // K, D ** -0.5 * np.log2(np.e)
    bf16 = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # noqa: E731
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for kh in range(K):
            for r0 in range(0, T * G, 64):
                t, g = np.divmod(np.arange(r0, min(r0 + 64, T * G)), G)
                qp = clen[b] - T + t
                hi = min(qp[-1], P * ps - 1)
                lo = 0 if window is None else max(0, qp[0] - window + 1)
                m, l, o = np.full(len(t), -1e30), np.zeros(len(t)), np.zeros((len(t), D))
                for s0 in range(lo // 64 * 64, hi + 1, 64):
                    p = s0 + np.arange(64)
                    page = np.where((p >= lo) & (p <= hi), bt[b, np.minimum(p // ps, P - 1)], -1)
                    slot = np.where(page >= 0, np.minimum(page, n_pages - 1) * ps + p % ps, -1)
                    kt, vt = (np.where(slot[:, None] >= 0, x.reshape(-1, K, D)[slot, kh], 0)
                              for x in (kp, vp))
                    ok = (slot >= 0) & (p <= qp[:, None])
                    if window is not None:
                        ok &= p > qp[:, None] - window
                    s = np.where(ok, q[b, t, kh * G + g] @ kt.T * c, -1e30)
                    m_new = np.maximum(m, s.max(1))
                    pm = np.exp2(s - m_new[:, None])
                    corr, m = np.exp2(m - m_new), m_new
                    l, o = l * corr + pm.sum(1), o * corr[:, None] + bf16(pm) @ vt
                res = o / np.maximum(l, 1e-30)[:, None]
                res[m == -1e30] = vp[np.clip(bt[b], 0, n_pages - 1), :, kh].reshape(-1, D).mean(0)
                out[b, t, kh * G + g] = res
    return bf16(out)


# case: (T, positions each row holds, window, rows that ride along, pages unset
# inside a row's length).  B=3, G=2, 16-position pages, 8 a row (128 positions)
ADMISSION_WALK_CASES = {
    "ragged_last_tile": (40, [100, 128, 57], None, (), ()),
    "ranges_start_and_end_mid_page": (20, [45, 83, 120], 19, (), ()),
    "unset_tail_pages": (16, [30, 17, 64], None, (), ((0, 1), (2, 3))),
    "window": (64, [128, 100, 70], 50, (), ()),
    "row_sees_nothing": (16, [0, 40, 0], None, (), ()),
    "ride_along_past_the_table": (48, [128, 100, 20], None, (0, 1), ()),
}


@pytest.mark.parametrize("case", ADMISSION_WALK_CASES)
def test_admission_tile_schedule_matches_pallas(case):
    """The K3 admission kernel's tile schedule, walked in numpy, against the
    reference's plain version and its Pallas kernel (interpret mode), bf16."""
    T, held, window, ride, holes = ADMISSION_WALK_CASES[case]
    rng = np.random.default_rng(len(case))
    B, P, ps, K, D, n_pages = 3, 8, 16, 2, 32, 24
    bt = np.full((B, P), -1, np.int32)
    ids = rng.permutation(n_pages)
    for b, L in enumerate(held):
        n = -(-L // ps)
        bt[b, :n], ids = ids[:n], ids[n:]
    for b, i in holes:
        bt[b, i] = -1
    clen = np.array([L + T if b in ride else max(L, T) for b, L in enumerate(held)], np.int32)
    jx = [jnp.asarray(rng.normal(size=s), jnp.bfloat16)
          for s in [(B, T, 2 * K, D), (n_pages, ps, K, D), (n_pages, ps, K, D)]]
    got = _admission_walk(*[np.asarray(a, np.float32) for a in jx], clen, bt, window)
    args = (*jx, jnp.asarray(clen), jnp.asarray(bt))
    for want in (jax_ref.decode_attention_paged(*args, window=window),
                 decode_attention_paged_pallas(*args, window=window, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# KVCacheManager serve mode, operation by operation (tests/test_paged_kv.py)
# ---------------------------------------------------------------------------

STEP_TOKENS = ([7, 7], [3], [9, 1, 4], [2, 2, 2, 2])
KV_CASES = {
    "incremental_hash": (64, {}, [("allocate_sequence", "r", list(range(10)), 4)]
                         + [("extend_up_to", "r", len(s), s) for s in STEP_TOKENS]
                         + [("match_prefix", list(range(10)) + [t for s in STEP_TOKENS
                                                                for t in s] + [99])]),
    "leading_run": (64, {}, [("allocate_sequence", "a", list(range(12))),
                             ("allocate_sequence", "b", list(range(12))),
                             ("allocate_sequence", "c", [*range(8), 99, 98, 97, 96])]),
    "resurrect": (8, {}, [("allocate_sequence", "a", list(range(12))), ("free_sequence", "a"),
                          ("match_prefix", list(range(12))),
                          ("allocate_sequence", "b", list(range(12))), ("free_sequence", "b"),
                          ("allocate_sequence", "x0", [100] * 16),
                          ("allocate_sequence", "x1", [101] * 16),
                          ("match_prefix", list(range(12))), ("free_sequence", "x0"),
                          ("allocate_sequence", "y", list(range(8)) + [5] * 8, 4)]),
    # the last prompt block is resident on the free list's head but past the
    # shareable run: it is recycled and its hash dropped, not re-registered
    "recycle": (3, {}, [("allocate_sequence", "a", list(range(8))), ("free_sequence", "a"),
                        ("allocate_sequence", "x", [50] * 4),
                        ("allocate_sequence", "b", list(range(8))),
                        ("match_prefix", list(range(8)) + [1])]),
    "ceiling": (64, {"max_seq_blocks": 3}, [("allocate_sequence", "big", list(range(13))),
                                            ("allocate_sequence", "ok", list(range(8))),
                                            ("extend_up_to", "ok", 8),
                                            ("ensure_margin", "ok", 4)]),
    "dense": (6, {"serve_prefixes": False}, [("allocate_sequence", "a", list(range(12)), 4),
                                             ("allocate_sequence", "b", list(range(12)), 4),
                                             ("extend_up_to", "b", 9), ("free_sequence", "a"),
                                             ("allocate_sequence", "c", list(range(8)))]),
}


@pytest.mark.parametrize("case", sorted(KV_CASES))
def test_kv_manager_matches_reference(case):
    n_blocks, kw = KV_CASES[case][:2]
    kw = {"block_size": 4, "serve_prefixes": True, **kw}
    ours, theirs = kv_cache.KVCacheManager(n_blocks, **kw), jax_kv.KVCacheManager(n_blocks, **kw)
    for op, *args in KV_CASES[case][2]:
        a, b = getattr(ours, op)(*args), getattr(theirs, op)(*args)
        if op == "allocate_sequence":
            a, b = a and dataclasses.asdict(a), b and dataclasses.asdict(b)
        assert a == b, (op, args)
        assert ours.hash_index == theirs.pool.hash_index
        assert list(ours.free) == list(theirs.pool.free)
        assert {h: n.parent_hash for h, n in theirs.pool.radix.nodes.items()} == ours.parent_of
        assert ours.hit_rate == theirs.hit_rate
    assert {k: dataclasses.asdict(v) for k, v in ours.seqs.items()} == \
        {k: dataclasses.asdict(v) for k, v in theirs.seqs.items()}


# ---------------------------------------------------------------------------
# the fp32 paged engine against the JAX paged engine
# ---------------------------------------------------------------------------

PAGED = {"paged_kv": True, "kv_blocks": 256, "kv_block_size": 16}
TINY_POOL = {"paged_kv": True, "kv_blocks": 7, "kv_block_size": 16}


def _engines(fp32_model, n_pairs, **kw):
    jcfg, jparams, tcfg, tparams = fp32_model
    kw = {"max_batch": 2, "max_len": 96, **kw}
    return (jax_engine.PipeServeEngine(jcfg, jparams, n_pairs=n_pairs,
                                       econf=jax_engine.EngineConfig(**kw)),
            PipeServeEngine(tcfg, tparams, n_pairs=n_pairs, econf=EngineConfig(**kw),
                            device="cpu", hardware=HardwareProfile(**dataclasses.asdict(TPU_V5E))))


def _copy(reqs):
    return [Request(prompt=list(r.prompt), request_id=r.request_id,
                    params=SamplingParams(max_new_tokens=r.params.max_new_tokens),
                    arrival_time=r.arrival_time) for r in reqs]


def _records(engine):
    return [dataclasses.asdict(r) for r in engine.monitor.completed]


# case -> (n_pairs, engine overrides, bursty-trace kwargs, arrival ticks or None)
ENGINE_CASES = {
    "bursty": (2, PAGED, {}, None),
    "shared_prefix": (2, PAGED, {"n": 1, "lo": 40, "hi": 41}, (0.0, 14.0)),
    "truncate": (1, {**TINY_POOL, "kv_evict_policy": "truncate"},
                 {"n": 4, "lo": 24, "hi": 33, "max_new": 24}, None),
    "beyond_max_len": (1, {**PAGED, "max_context": 192},
                       {"n": 1, "lo": 120, "hi": 121, "max_new": 16}, None),
    "oversize": (1, PAGED, {"n": 1, "lo": 120, "hi": 121}, None),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_paged_engine_matches_jax_engine(fp32_model, trace_factory, case):
    n_pairs, econf, trace, arrivals = ENGINE_CASES[case]
    jreqs = trace_factory("bursty", **trace)
    if arrivals:  # the same prompt again, once the first has finished
        jreqs = [*jreqs, *trace_factory("bursty", **trace)]
        for r, t in zip(jreqs, arrivals, strict=True):
            r.arrival_time = t
    treqs = _copy(jreqs)
    jeng, teng = _engines(fp32_model, n_pairs, **econf)
    _serve(jeng, jreqs)
    _serve(teng, treqs)
    assert [r.output_tokens for r in treqs] == [r.output_tokens for r in jreqs]
    for field in ("worker_id", "cache_hit_tokens", "kv_requeued", "error"):
        assert [getattr(r, field) for r in treqs] == [getattr(r, field) for r in jreqs], field
    assert _records(teng) == _records(jeng)
    assert len(_records(teng)) == len(treqs)
    if case == "shared_prefix":  # the repeat hits the holder's pages
        assert treqs[1].cache_hit_tokens == 32 and treqs[1].worker_id == treqs[0].worker_id
    if case == "truncate":
        assert any(r["kv_evicted"] for r in _records(teng))
    if case == "beyond_max_len":
        assert len(treqs[0].output_tokens) == 16
    if case == "oversize":
        assert treqs[0].error == "exceeds_max_context"


# (max_batch, kv_blocks, n): the reference's trace, and a wider batch in
# which the victim order (latest deadline, then highest slot) matters
@pytest.mark.parametrize("max_batch, kv_blocks, n", [(2, 7, 4), (4, 10, 6)])
def test_requeue_pressure_matches_jax_engine_step_by_step(fp32_model, trace_factory,
                                                          max_batch, kv_blocks, n):
    """The reference's requeue pressure trace never drains (its own test
    fails); the port does what the JAX engine does, step by step: the same
    records, requeue counts and pool use, with evictions seen."""
    jreqs = trace_factory("bursty", n=n, lo=24, hi=33, max_new=24)
    treqs = _copy(jreqs)
    jeng, teng = _engines(fp32_model, 1, **{**TINY_POOL, "kv_blocks": kv_blocks},
                          max_batch=max_batch)
    for jr, tr in zip(jreqs, treqs, strict=True):
        jeng.submit(jr)
        teng.submit(tr)
    for _ in range(40):
        jeng.step()
        teng.step()
        assert teng.pairs[0].kv.used == jeng.pairs[0].kv.pool.used
        assert [r.kv_requeued for r in treqs] == [r.kv_requeued for r in jreqs]
        assert [r.output_tokens for r in treqs] == [r.output_tokens for r in jreqs]
        assert _records(teng) == _records(jeng)
    assert sum(r.kv_requeued for r in treqs) > 0


def test_streamserve_paged_on_cpu():
    """Through the API: a prompt past max_len serves under max_context, a
    repeat of a served prefix hits, and the paged fields are validated."""
    cfg = ServeConfig.reduced_smoke(paged_kv=True, kv_block_size=16, max_context=192)
    serve = StreamServe(cfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, serve.arch.vocab_size, 120).tolist()
    first = serve.submit(prompt)
    assert len(first.result()) == cfg.max_new_tokens
    again = serve.submit(prompt)
    assert again.result() == first.result() and again.request.cache_hit_tokens == 112
    with pytest.raises(ValueError, match="exceeds max_context"):
        serve.submit(list(range(190)))
    for bad in ({"kv_evict_policy": "drop"}, {"max_context": 64}, {"max_len": 90}):
        with pytest.raises(ValueError, match="paged_kv requires"):  # the engine's gate
            StreamServe(cfg.replace(**bad), device="cpu")
