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
from test_torch_engine import PAGED, _copy, _engines, _records, _refused, _serve_both
from test_torch_kernels import _close, _pair
from test_torch_engine import _one_torch_thread, fp32_model  # noqa: F401

from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import decode_attention_paged_pallas, decode_attention_pallas
from repro.serving import kv_cache as jax_kv
from repro_torch.api import ServeConfig, StreamServe
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_paged_cuda
from repro_torch.serving import kv_cache

# (T, dtype, window): decode and verify sizes, an admission-sized T, bf16
@pytest.mark.parametrize("T, dt, window", [(1, "float32", None), (3, "float32", None),
                                           (9, "float32", 7), (32, "float32", None),
                                           (3, "bfloat16", None), (32, "bfloat16", None)])
def test_paged_plain_matches_reference_and_pallas(T, dt, window, H=4, K=2, D=32):
    """Shuffled non-contiguous pages, ragged -1 tails, a cache_len that ends
    mid-page and a row whose table is all -1 (its output is finite)."""
    rng = np.random.default_rng(T)
    B, P, ps, n_pages = 4, 4, 16, 24
    clen = np.array([T + 5, P * ps, T + 21, T + 2], np.int32)
    bt = _tables(rng, [*clen[:-1], 0], P, n_pages)
    jx, tx = zip(*(_pair(rng, s, dt) for s in [(B, T, H, D), (n_pages, ps, K, D),
                                                (n_pages, ps, K, D)]), strict=True)
    got = ops.decode_attention_paged(*tx, torch.from_numpy(clen), torch.from_numpy(bt),
                                     window=window)
    assert torch.isfinite(got).all()
    for want in _paged_refs(jx, clen, bt, window):
        _close(got, want, dt)


# head_dim 120 (h2o-danube) and G = 5 and 9 (qwen2.5-14b, starcoder2-7b):
# (H, K, D, T, dtype, window)
@pytest.mark.parametrize("H, K, D, T, dt, window", [
    (10, 2, 120, 9, "float32", None), (9, 1, 128, 9, "float32", 20),
    (5, 1, 120, 32, "float32", None), (18, 2, 120, 3, "bfloat16", 11)])
def test_paged_plain_matches_pallas_at_m9_shapes(H, K, D, T, dt, window):
    test_paged_plain_matches_reference_and_pallas(T, dt, window, H, K, D)


def test_paged_cuda_wrapper_refuses_cpu_tensors():
    _refused(decode_attention_paged_cuda, torch.zeros(1, 2, 4, 32), torch.zeros(4, 16, 2, 32),
             torch.zeros(4, 16, 2, 32), torch.tensor([2], dtype=torch.int32),
             torch.zeros(1, 2, dtype=torch.int32))


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _split_walk(qs, n_tiles, n_split, seen, tile):
    """K1's and K3's bf16 tile loop with split-KV, for one (batch row, KV head,
    query tile) in numpy.  qs (R, D) are the rows' queries times scale *
    log2(e).  The n_tiles tiles of 64 positions are cut into n_split static
    ranges of ceil(n_tiles / n_split); split s walks the tiles of its range
    that lie in ``seen``, a split with none is marked empty.  tile(i) gives
    tile i's K and V rows (64, D), its visibility (R, 64) and whether each
    position exists.  Each split runs a base-2 online softmax (masked scores
    -1e30, positions that do not exist -inf) with P rounded to bf16 before
    P.V; the combine skips the empty splits:  M = max m_i,  O = sum 2^(m_i -
    M) O_i / sum 2^(m_i - M) l_i.  Returns (O, M)."""
    span, parts = -(-n_tiles // n_split), []
    for s in range(n_split):
        walked = [i for i in range(s * span, min(n_tiles, (s + 1) * span)) if i in seen]
        if not walked:
            continue
        m, l, o = np.full(len(qs), -1e30), np.zeros(len(qs)), np.zeros(qs.shape)
        for i in walked:
            kt, vt, ok, exists = tile(i)
            sc = np.where(exists, np.where(ok, qs @ kt.T, -1e30), -np.inf)
            m_new = np.maximum(m, sc.max(1))
            p = np.exp2(sc - m_new[:, None])
            corr, m = np.exp2(m - m_new), m_new
            l, o = l * corr + p.sum(1), o * corr[:, None] + _bf16(p) @ vt
        parts.append((m, l, o))
    M = np.max([m for m, _, _ in parts], axis=0) if parts else np.full(len(qs), -np.inf)
    w = [np.exp2(m - M) for m, _, _ in parts]
    L = sum((wi * l for wi, (_, l, _) in zip(w, parts, strict=True)), np.zeros(len(qs)))
    O = sum((wi[:, None] * o for wi, (_, _, o) in zip(w, parts, strict=True)), np.zeros(qs.shape))
    return O / np.maximum(L, 1e-30)[:, None], M


def _walk(q, clen, K, n_tiles, n_split, rows, visit):
    """The bf16 K1/K3 tile loop over (batch row b, KV head kh, query tile of
    ``rows`` rows r = t*G + g); ``visit(b, kh, qp)`` gives the tile function
    of _split_walk, the tiles the query tile walks and what a row that saw
    nothing gets (None: what the walk gives)."""
    B, T, H, D = q.shape
    G, c = H // K, D ** -0.5 * np.log2(np.e)
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for kh in range(K):
            for r0 in range(0, T * G, rows):
                t, g = np.divmod(np.arange(r0, min(r0 + rows, T * G)), G)
                tile, seen, empty = visit(b, kh, clen[b] - T + t)
                res, M = _split_walk(q[b, t, kh * G + g] * c, n_tiles, n_split, seen, tile)
                if empty is not None:
                    res[M <= -1e30] = empty
                out[b, t, kh * G + g] = res
    return _bf16(out)


def _paged_walk(q, kp, vp, clen, bt, window, n_split=1):
    """paged_wgmma_kernel's schedule: query tiles of 64 rows (128 where
    T*G > 64: two warpgroups); each tile's rows see positions [lo, hi] (hi
    clamped to P*ps - 1), and a split walks the tiles of its range over P*ps
    that meet them, gathering each position's slot from the table (clamped;
    -1 outside [lo, hi] or unset: masked and read as zeros).  A row that saw
    nothing (M <= -1e30) gets the mean of V over every table entry, an unset
    entry read as page 0."""
    T, H = q.shape[1:3]
    n_pages, ps, K, D = kp.shape
    P = bt.shape[1]

    def visit(b, kh, qp):
        hi, lo = min(qp[-1], P * ps - 1), 0 if window is None else max(0, qp[0] - window + 1)

        def tile(i):
            p = 64 * i + np.arange(64)
            page = np.where((p >= lo) & (p <= hi), bt[b, np.minimum(p // ps, P - 1)], -1)
            slot = np.where(page >= 0, np.minimum(page, n_pages - 1) * ps + p % ps, -1)
            kt, vt = (np.where(slot[:, None] >= 0, x.reshape(-1, K, D)[slot, kh], 0)
                      for x in (kp, vp))
            ok = (slot >= 0) & (p <= qp[:, None])
            if window is not None:
                ok &= p > qp[:, None] - window
            return kt, vt, ok, np.ones(64, bool)

        return (tile, range(lo // 64, hi // 64 + 1) if hi >= lo else range(0),
                vp[np.clip(bt[b], 0, n_pages - 1), :, kh].reshape(-1, D).mean(0))

    rows = 64 if T * (H // K) <= 64 else 128
    return _walk(q, clen, K, -(-P * ps // 64), n_split, rows, visit)


def _dense_walk(q, k, v, clen, pos, window, n_split):
    """decode_wgmma_kernel's schedule: one query tile of the T*G rows; a
    split walks every slot of its range over S (a ring's slot order is not
    position order), slot j visible iff 0 <= pos[j] <= q_pos (and > q_pos -
    window), slots past S absent.  A row that sees nothing keeps M = -1e30
    in every split: equal weights, the mean of V over all S."""
    T, H = q.shape[1:3]
    S, K = k.shape[1:3]

    def visit(b, kh, qp):
        def tile(i):
            p = 64 * i + np.arange(64)
            exists = p < S
            kv_pos = np.where(exists, pos[b, np.minimum(p, S - 1)], -1)
            kt, vt = (np.where(exists[:, None], x[b, np.minimum(p, S - 1), kh], 0) for x in (k, v))
            ok = (kv_pos >= 0) & (kv_pos <= qp[:, None])
            if window is not None:
                ok &= kv_pos > qp[:, None] - window
            return kt, vt, ok, exists

        return tile, range(-(-S // 64)), None

    return _walk(q, clen, K, -(-S // 64), n_split, T * H // K, visit)


def _tables(rng, held, P, n_pages, ps=16):
    """Block tables (len(held), P): row b's first ceil(held[b] / ps) entries
    are distinct pages of the shuffled pool, the rest -1."""
    bt = np.full((len(held), P), -1, np.int32)
    ids = rng.permutation(n_pages)
    for b, L in enumerate(held):
        n = -(-L // ps)
        bt[b, :n], ids = ids[:n], ids[n:]
    return bt


def _paged_inputs(rng, T, held, ride=(), holes=(), P=8):
    """G=2, 16-position pages, P a row: shuffled pages holding held[b]
    positions, bf16."""
    B, ps, K, D, n_pages = len(held), 16, 2, 32, 3 * P
    bt = _tables(rng, held, P, n_pages)
    for b, i in holes:
        bt[b, i] = -1
    clen = np.array([L + T if b in ride else max(L, T) for b, L in enumerate(held)], np.int32)
    jx = [jnp.asarray(rng.normal(size=s), jnp.bfloat16)
          for s in [(B, T, 2 * K, D), (n_pages, ps, K, D), (n_pages, ps, K, D)]]
    return jx, clen, bt


def _paged_refs(jx, clen, bt, window):
    """The reference's plain paged attention and its Pallas kernel (interpret
    mode) on the same inputs."""
    args = (*jx, jnp.asarray(clen), jnp.asarray(bt))
    return (jax_ref.decode_attention_paged(*args, window=window),
            decode_attention_paged_pallas(*args, window=window, interpret=True))


def _f32(jx):
    return [np.asarray(a, np.float32) for a in jx]


def _close_all(got, *wants):
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


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
    """The K3 kernel's tile schedule at admission shapes (one split), walked in
    numpy, against the reference's plain version and its Pallas kernel
    (interpret mode), bf16."""
    T, held, window, ride, holes = ADMISSION_WALK_CASES[case]
    jx, clen, bt = _paged_inputs(np.random.default_rng(len(case)), T, held, ride, holes)
    _close_all(_paged_walk(*_f32(jx), clen, bt, window), *_paged_refs(jx, clen, bt, window))


def _ring_cache(rng, B, T, S, fill, stale=0):
    """A ring of S slots (slot = position % S): row b holds its last
    min(fill[b] + T, S) positions; ``stale`` slots after a row that has not
    wrapped hold positions past its horizon, as a rejected verify leaves
    them.  bf16 q, k, v (H = 4, K = 2, D = 32)."""
    clen = np.array([f + T for f in fill], np.int32)
    pos = np.full((B, S), -1, np.int32)
    for b, L in enumerate(clen):
        p = np.arange(max(0, L - S), L + (stale if L + stale <= S else 0))
        pos[b, p % S] = p
    jx = [jnp.asarray(rng.normal(size=s), jnp.bfloat16)
          for s in [(B, T, 4, 32), (B, S, 2, 32), (B, S, 2, 32)]]
    return jx, clen, pos


# case: (kernel, T, positions held a row, window, n_split, idle row).  B=3;
# K3 over 256 positions a row (4 tiles), K1 over a ring of S = 200 slots (4
# tiles, the last with 8 slots), or 256 with an idle row: the reference's
# Pallas kernel pads S to its block with masked zero slots, so where S is not
# a multiple of the block its fully masked row averages the padding too
# (ROADMAP §3), while its plain version and the port average over S
SPLIT_WALK_CASES = {
    "paged_T1": ("paged", 1, [200, 256, 57], None, 4, None),
    "paged_T9_window": ("paged", 9, [256, 180, 70], 50, 4, None),
    "paged_split_left_empty_by_a_short_row": ("paged", 5, [10, 256, 3], None, 4, None),
    "paged_row_sees_nothing": ("paged", 3, [0, 40, 0], None, 2, None),
    "dense_wrapped_ring_and_stale_slots": ("dense", 5, [300, 100, 40], 70, 4, None),
    "dense_idle_row": ("dense", 3, [150, 20, 190], None, 2, 1),
}


@pytest.mark.parametrize("case", SPLIT_WALK_CASES)
def test_split_kv_schedule_matches_pallas(case):
    """The bf16 K1 and K3 kernels' split-KV schedule and LSE combine, walked
    in numpy, against the reference's plain versions, its Pallas kernels
    (interpret mode) and the port's plain versions, bf16."""
    kernel, T, held, window, n_split, idle = SPLIT_WALK_CASES[case]
    rng = np.random.default_rng(len(case))
    if kernel == "paged":
        jx, clen, bt = _paged_inputs(rng, T, held, P=16)
        tx = [torch.from_numpy(a).bfloat16() for a in _f32(jx)]
        _close_all(_paged_walk(*_f32(jx), clen, bt, window, n_split),
                   *_paged_refs(jx, clen, bt, window),
                   ops.decode_attention_paged(*tx, torch.from_numpy(clen), torch.from_numpy(bt),
                                              window=window).float())
        return
    jx, clen, pos = _ring_cache(rng, len(held), T, 200 if idle is None else 256, held, stale=4)
    if idle is not None:
        pos[idle] = -1
    got = _dense_walk(*_f32(jx), clen, pos, window, n_split)
    args, kw = (*jx, jnp.asarray(clen)), {"kv_positions": jnp.asarray(pos), "window": window}
    want = [jax_ref.decode_attention(*args, **kw),
            decode_attention_pallas(*args, **kw, interpret=True, block_k=64)]
    tx = [torch.from_numpy(a).bfloat16() for a in _f32(jx)]
    _close_all(got, *want, ops.decode_attention(*tx, torch.from_numpy(clen),
                                               kv_positions=torch.from_numpy(pos),
                                               window=window).float())


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
    # chunked ingest's private allocation: nothing shared, nothing registered,
    # its generated blocks never hashed; a later shared one finds nothing
    "private": (64, {}, [("allocate_sequence", "a", list(range(12))),
                         ("allocate_sequence", "p", list(range(12)), 4, False),
                         ("extend_up_to", "p", 4, [1, 2, 3, 4]),
                         ("allocate_sequence", "q", [*range(12), 1, 2, 3, 4, 5]),
                         ("match_prefix", [*range(12), 1, 2, 3, 4, 5])]),
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

TINY_POOL = {"paged_kv": True, "kv_blocks": 7, "kv_block_size": 16}


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
    _serve_both(jeng, teng, jreqs, treqs)
    assert [r.kv_requeued for r in treqs] == [r.kv_requeued for r in jreqs]
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
