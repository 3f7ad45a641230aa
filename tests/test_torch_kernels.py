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

from repro.kernels import ref as jax_ref
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
# queries sit at the END of a longer KV; then head_dim 120 (h2o-danube) and
# the M9 models' query heads a KV head, G = 5 (qwen2.5-14b) and 9
# (starcoder2-7b), ragged, windowed and continued; then not causal at
# head_dim 64 (seamless's encoder, G = 1) and G = 7 (internvl2's heads)
@pytest.mark.parametrize("case, q_offset", [(c, 0) for c in FLASH_CASES]
                         + [((1, 32, 128, 4, 4, 64, True, None, jnp.float32), 96),
                            ((1, 80, 80, 5, 1, 120, True, None, jnp.float32), 0),
                            ((1, 96, 96, 9, 1, 120, True, 40, jnp.float32), 0),
                            ((1, 64, 64, 10, 2, 120, True, None, jnp.bfloat16), 0),
                            ((1, 40, 136, 9, 1, 128, True, 48, jnp.float32), 96),
                            ((1, 100, 100, 4, 4, 64, False, None, jnp.float32), 0),
                            ((2, 70, 70, 14, 2, 64, False, None, jnp.float32), 0),
                            ((1, 64, 64, 7, 1, 64, False, None, jnp.bfloat16), 0)])
def test_flash_plain_matches_pallas(case, q_offset):
    B, Sq, Sk, H, K, D, causal, window, jdt = case
    dt, rng = jnp.dtype(jdt).name, np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dt) for s in
                                    [(B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)])
    kw = {"causal": causal, "window": window, "q_offset": q_offset}
    want = flash_attention_pallas(jq, jk, jv, interpret=True, block_q=64, block_k=64, **kw)
    _close(ops.flash_attention(tq, tk, tv, **kw), want, dt)
    _close(ref.flash_attention(tq, tk, tv, q_chunk=32, **kw), want, dt)  # chunked


# the reference's table (B, T, S, H, K, D, window, ring, dtype: random
# lengths, ring positions where it says ring); then head_dim 120 and G = 4, 5
# and 9 at decode and verify sizes, with the positions each row holds before
# its T new ones in place of ``ring`` (a row whose positions outnumber S has
# wrapped its ring); then cross attention (a last field, causal False) at
# head_dim 64, G = 1 and 7, each row's memory length in place of ``ring`` (0
# included: every slot invalid), T past it as in a prefill's cross call
DECODE = {f"case{i}": c for i, c in enumerate(DECODE_CASES)} | {
    "d120-g4-wrapped-window": (2, 3, 96, 8, 2, 120, 40, [150, 20], jnp.float32),
    "g5-verify": (2, 9, 128, 5, 1, 128, None, [60, 100], jnp.float32),
    "g9-verify-wrapped-window": (2, 9, 96, 9, 1, 128, 24, [200, 30], jnp.float32),
    "d120-g9-bfloat16": (2, 5, 128, 18, 2, 120, None, [70, 10], jnp.bfloat16),
    "d120-g5-wrapped-window-bfloat16": (1, 2, 64, 10, 2, 120, 16, [100], jnp.bfloat16),
    "cross-g1": (3, 5, 96, 4, 4, 64, None, [96, 37, 0], jnp.float32, False),
    "cross-g7-bfloat16": (2, 9, 80, 14, 2, 64, None, [1, 80], jnp.bfloat16, False),
    "cross-t-past-memory": (2, 40, 24, 2, 2, 64, None, [24, 5], jnp.float32, False),
}


@pytest.mark.parametrize("case", DECODE)
def test_decode_plain_matches_pallas(case):
    B, T, S, H, K, D, window, ring, jdt, *cross = DECODE[case]
    fill = ring if isinstance(ring, list) else None
    dt, rng = jnp.dtype(jdt).name, np.random.default_rng(3 if fill is None else 6)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dt) for s in
                                    [(B, T, H, D), (B, S, K, D), (B, S, K, D)])
    if cross:  # the reference runs cross attention in its plain version only
        mem_len = np.array(fill, np.int32)
        want = jax_ref.decode_attention(jq, jk, jv, jnp.asarray(mem_len), causal=False)
        tlen = torch.from_numpy(mem_len)
        for pos in (None, dense_positions(tlen, S)):  # what the model passes: mem_pos
            _close(ops.decode_attention(tq, tk, tv, tlen, kv_positions=pos, causal=False),
                   want, dt)
        return
    clen = (np.array([f + T for f in fill], np.int32) if fill else
            rng.integers(T, S, size=(B,)).astype(np.int32))
    pos = np.array(_ring_positions(B, S, clen)) if ring else None
    want = decode_attention_pallas(jq, jk, jv, jnp.asarray(clen), interpret=True, block_k=64,
                                   window=window, kv_positions=pos)
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
