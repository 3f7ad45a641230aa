"""The port's attention kernels: plain versions against the JAX Pallas kernels
(interpret mode) on the reference's case tables, and the CUDA wrappers.

The same numpy inputs go to both frameworks.  Tolerances are the reference's
own (tests/test_kernels.py): 2e-5 in float32, 2e-2 in bfloat16.  The CUDA
kernels themselves have no CPU mode: ``chip_smoke.py`` holds them to these
plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import DECODE_CASES, FLASH_CASES, _ring_positions
from test_torch_engine import _one_torch_thread, _refused  # noqa: F401

from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda, dense_positions
from repro_torch.kernels.flash_attention import flash_attention_cuda

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(rng, shape, dt):
    """The same random values as a JAX array and a torch tensor of dtype dt."""
    a = jnp.asarray(rng.normal(size=shape), dt)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dt))


def _close(got, want, dt, tols=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tols[dt], rtol=tols[dt])


# (case, q_offset): the reference's table, plus a continuation block whose
# queries sit at the END of a longer KV
@pytest.mark.parametrize("case, q_offset", [(c, 0) for c in FLASH_CASES]
                         + [((1, 32, 128, 4, 4, 64, True, None, jnp.float32), 96)])
def test_flash_plain_matches_pallas(case, q_offset):
    B, Sq, Sk, H, K, D, causal, window, jdt = case
    dt, rng = jnp.dtype(jdt).name, np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dt) for s in
                                    [(B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)])
    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    want = flash_attention_pallas(jq, jk, jv, interpret=True, block_q=64, block_k=64, **kw)
    _close(ops.flash_attention(tq, tk, tv, **kw), want, dt)
    _close(ref.flash_attention(tq, tk, tv, q_chunk=32, **kw), want, dt)  # chunked


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_pallas(case):
    B, T, S, H, K, D, window, ring, jdt = case
    dt, rng = jnp.dtype(jdt).name, np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dt) for s in
                                    [(B, T, H, D), (B, S, K, D), (B, S, K, D)])
    clen = rng.integers(T, S, size=(B,)).astype(np.int32)
    pos = np.array(_ring_positions(B, S, clen)) if ring else None
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(clen), interpret=True, block_k=64,
                                   window=window, kv_positions=None if pos is None else pos)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(clen), window=window,
                               kv_positions=None if pos is None else torch.from_numpy(pos))
    _close(got, want, dt)


@pytest.mark.parametrize("idle_row", [False, True])
def test_decode_plain_stale_slots_and_idle_rows(idle_row):
    """Slots holding positions above the horizon (rolled-back speculative
    writes) contribute nothing, whatever they hold; an idle slot (every
    kv_pos = -1) gives a finite output, the mean of V, as the TPU kernel."""
    rng = np.random.default_rng(4)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, "float32") for s in
                                    [(2, 3, 4, 32), (2, 48, 2, 32), (2, 48, 2, 32)])
    clen = np.array([20, 33], np.int32)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48)).copy()
    if idle_row:
        pos[0] = -1
    args = (torch.from_numpy(clen),)
    clean = ops.decode_attention(tq, tk, tv, *args, kv_positions=torch.from_numpy(pos))
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[1, 33:], tv2[1, 33:] = 999.0, -999.0
    poisoned = ops.decode_attention(tq, tk2, tv2, *args, kv_positions=torch.from_numpy(pos))
    assert torch.isfinite(clean).all()
    np.testing.assert_allclose(poisoned[1].numpy(), clean[1].numpy(), atol=1e-6)
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(clen), interpret=True,
                                   block_k=16, kv_positions=jnp.asarray(pos))
    _close(clean, want, "float32")


def test_decode_wrapper_dense_positions_follow_the_plain_rule():
    """Without kv_positions the plain version takes slot i to hold position i
    while i < cache_len; the CUDA wrapper builds those positions explicitly
    for the kernel, and they give the plain version the same result."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in [(3, 2, 4, 32), (3, 40, 2, 32), (3, 40, 2, 32)])
    clen = torch.tensor([2, 17, 40], dtype=torch.int32)
    pos = dense_positions(clen, 40)
    assert pos.dtype == torch.int32 and pos[1, 16] == 16 and pos[1, 17] == -1
    torch.testing.assert_close(ref.decode_attention(q, k, v, clen, kv_positions=pos),
                               ref.decode_attention(q, k, v, clen), atol=0, rtol=0)


@pytest.mark.parametrize("wrapper", [decode_attention_cuda, flash_attention_cuda])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper):
    """A wrapper launches its kernel or raises: it never computes on the CPU,
    and a refused call does not count as a launch."""
    q, k = torch.zeros(1, 2, 4, 32), torch.zeros(1, 8, 2, 32)
    extra = (torch.tensor([2], dtype=torch.int32),) if wrapper is decode_attention_cuda else ()
    _refused(wrapper, q, k, k, *extra)


def test_library_path_follows_shared_headers(tmp_path, monkeypatch):
    """A built kernel is named by its source, every shared csrc/*.cuh header
    and the flags, so an edited header is never served from a stale build."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "tile.cuh"\n')
    (tmp_path / "tile.cuh").write_text("// v1\n")
    first = build.library_path("k")
    (tmp_path / "tile.cuh").write_text("// v2\n")
    edited = build.library_path("k")
    (tmp_path / "more.cuh").write_text("")
    assert len({first, edited, build.library_path("k")}) == 3
    (tmp_path / "more.cuh").unlink()
    assert build.library_path("k") == edited
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-lineinfo"))
    assert build.library_path("k") != edited
