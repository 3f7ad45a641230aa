"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure:
  1. print the card (nvidia-smi name and power limit) and versions; build the
     CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
     all at once); show from the SASS that the bf16 attention kernels (K1,
     K2, K3) run both products, and the bf16 SSD-scan kernel (K4) its four,
     on HGMMA (wgmma);
  2. hold each kernel against its plain PyTorch version at the serving
     shapes (bf16, plus fp32, stale-slot poisoning, fully masked rows, and
     for the paged kernel shuffled pages, ragged -1 tails and a window; at
     the edges of the bf16 tensor-core kernels: prefill lengths that are not
     a multiple of the 64-row tile, a window with a q_offset, K1 over a
     ragged last tile and a wrapped ring with a window, rows short enough to
     leave splits empty, ranges that start and end mid-page, rows that see
     nothing or whose positions pass the table), check that bf16 takes the
     tensor-core kernel and fp32 the CUDA-core one, and time kernel, plain
     version and the library yardstick (``scaled_dot_product_attention``;
     for the paged kernel a gather plus SDPA, two calls) beside the previous
     kernels' times, K1 also at the chunked serve's chunk step (B=4 T=64);
  3. check the full-width model on the card against the same weights on the
     CPU (2 layers, float32: every K1 and K3 launch on the CUDA-core
     kernels), dense and paged; and a 300-token prompt ingested in chunks of
     64 against its one-shot prefill, on the card;
  4. serve qwen3-1.7b at full width (28 layers, d_model 2048) with 2 stream
     pairs through ``StreamServe``, counting kernel launches (every bf16 K1,
     K2 and, in phase 6, K3 launch must take the tensor-core kernel);
  5. time a burst of 8 requests, then profile the same burst (device busy
     share of the wall, device time by kernel); serve the dense serve's
     prompts with chunked prefill (chunk 64: every chunk step a K1 launch a
     layer, no K2) and profile a burst; run the long-prompt trace with EDF
     preemption on and off (the shorts' TTFT must be lower with it on);
  6. serve the same model with paged KV (max_context 1024): shared-prefix
     requests that hit the radix index, prompts beyond max_len; profile a
     paged burst; then a burst that outgrows a small pool and truncates;
     then chunked (K1 on every chunk step, K3 on every decode call, no
     prefix hit: chunked ingest is private);
  7. llama2-7b, the paper's model (MHA: one query head a KV head): hold K1,
     K2 and K3 at H = K = 32 against their plain versions (K1 at the paper
     serve's B=16 S=2048 for T = 1, 2, 3, 5, 9 and an unbucketed 7, with an
     idle row, and fp32; K2 at the 2048 bucket and a ragged length; K3
     decode) and time K1 and K2 there; check 2 full-width layers on the card
     against the CPU (fp32); serve the paper's operating point
     (``paper_stream_pairs("llama2-7b", draft="model")``: 2 pairs x 16
     slots, max_len 2048, the 2-layer model draft) with a burst of 20
     requests of 16-1500 tokens, counting K1 and K2 launches by lane, and
     profile a burst; the ablation serve (round-robin, single depth 4, no
     verify buckets: K1 at T = 5); the self-draft check (2 fp32 layers as
     their own draft: the tokens of plain decoding);
  8. hold the SSD-scan kernel against its plain version (bf16 and fp32, 1,
     2 and 4 groups, ragged tails, one chunk and one more, an initial state,
     the serve shape, 2 and 4 chunks a block), check that bf16 takes the
     tensor-core kernel and fp32 the CUDA-core one, and time it; check 2
     full-width mamba2-2.7b layers on the card against the CPU (fp32: every
     K4 launch on the CUDA-core kernel); serve mamba2-2.7b at full width (64
     layers, d_model 2560), counting SSD-scan launches (every one on the
     tensor-core kernel), and profile a burst, splitting device time between
     prefill and decode;
  9. print the kernel table as one JSON line, then the result line.
Every serve of phases 4-8 runs twice on the same weights: eager (its lanes'
graph caches cleared, so each step runs op by op), then on CUDA graphs
(warmed up: every fixed-shape step captured), each profiled; the graphed
serve must give the eager one's tokens and launch counts and capture
nothing after warmup (the unbucketed ablation excepted), and the dense serve
also runs sampled (temperature 1.0), seed for seed.  The dense and paper
serves also split a step's host time (dispatch, device wait, bookkeeping).
Without CUDA, or outside a checkout, it exits non-zero and prints no result.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                                 # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}         # dense, per type
TOL = {"bfloat16": 2e-2, "float32": 2e-5}                 # tests/test_kernels.py:19
SSD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}             # tests/test_kernels.py:180-181
# the bf16 kernels' times on the CUDA cores, before they moved to the tensor
# cores (PERF.md §6, by this script, NVIDIA H100 80GB HBM3, 700.00 W)
PREVIOUS_MS = {"flash_attention": 0.2979, "admission": 5.2586, "decode_attention": 0.1722,
               "decode": 0.4635, "ssd_scan": 0.2542}
REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention.py:113",
    "flash_attention": "src/repro/kernels/flash_attention.py:131",
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:257",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:122",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def timed(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events.  A
    spin kernel (~50 ms) ahead of the start event lets the host queue the
    calls before the device reaches them, so they run back to back and the
    time is the device's, not the host's rate of issue (a wrapper's Python
    and ctypes cost tens of microseconds a call, as much as a short kernel)."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies(make, nbytes: int) -> list:
    """Enough copies of an input set to exceed the 50 MB L2 cache, so that a
    timed launch finds its inputs in device memory as a decode step does."""
    return [make() for _ in range(max(2, -(-120_000_000 // max(nbytes, 1))))]


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check(name: str, got, want, dt: str, tols: dict = TOL) -> float:
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err = max_err(got, want)
    diff, ref, tol = (got.float() - want.float()).abs(), want.float().abs(), tols[dt]
    if not bool((diff <= tol + tol * ref).all()):  # atol = rtol = tol
        fail(f"{name}: kernel and plain version differ (max abs {err:.3g}, tol {tol})")
    return err


# ------------------------------------------------------------------ kernels

def tensor_core_sass(report: dict) -> None:
    """The bf16 kernels' products as compiled: the HGMMA (wgmma) instruction
    forms in the SASS of decode_wgmma_kernel, flash_wgmma_kernel and
    paged_wgmma_kernel at head_dim 128, and of ssd_wgmma_kernel (``cuobjdump
    -sass`` of the built libraries).  Fails unless each attention kernel holds
    S = QK^T (64x64x16) and O += PV (64x128x16) on the tensor cores, and the
    SSD scan its scores, intra- and inter-chunk terms (64x64x16) and state
    update (64x128x16)."""
    import re

    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    found = {}
    for lib, kernel, tag in (("decode_attention", "decode_wgmma_kernel", "ILi128E"),
                             ("flash_attention", "flash_wgmma_kernel", "ILi128E"),
                             ("decode_attention_paged", "paged_wgmma_kernel", "ILi128E"),
                             ("ssd_scan", "ssd_wgmma_kernel", "")):
        sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, timeout=120).stdout
        fn, forms = "", set()
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line
            elif "HGMMA" in line and kernel in fn and tag in fn:
                forms.add(re.search(r"HGMMA\.(\S+)", line).group(1))
        found[kernel] = sorted(forms)
        print(f"{kernel}{' (head_dim 128)' if tag else ''} SASS: HGMMA "
              f"{', '.join(found[kernel]) or 'none'}")
        if not all(any(f.startswith(shape) for f in forms) for shape in ("64x64x16.F32.BF16",
                                                                          "64x128x16.F32.BF16")):
            fail(f"{kernel}: the SASS does not run its products on HGMMA")
    report["hgmma"] = found


def decode_case(g, B, T, S, H, K, D, dt, fill, poison=True, ring=False):
    """Decode inputs as the serving path makes them: row b holds fill[b]
    committed positions, the T new tokens written after them, and stale
    speculative slots (positions past the horizon) poisoned.  With ``ring``
    the cache is a ring of S slots (slot = position % S) and a row may hold
    more than S positions: its last S, wrapped."""
    import torch

    dev, dtype = "cuda", getattr(torch, dt)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, K, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, K, D, generator=g, device=dev).to(dtype)
    clen = torch.tensor([f + T if ring else min(f + T, S) for f in fill], dtype=torch.int32,
                        device=dev)
    pos = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    for b, L in enumerate(clen.tolist()):
        if ring and L > S:  # wrapped: no stale slot survives a full ring
            p = torch.arange(L - S, L, dtype=torch.int32, device=dev)
            pos[b, p.long() % S] = p
            continue
        pos[b, :L] = torch.arange(L, dtype=torch.int32, device=dev)
        if poison and L < S and fill[b] > 0:  # stale slots from a rejected verify
            n = min(8, S - L)
            pos[b, L:L + n] = torch.arange(L, L + n, dtype=torch.int32, device=dev)
            k[b, L:L + n], v[b, L:L + n] = 60.0, -60.0
    return q, k, v, clen, pos


def decode_cost(q, k, clen, pos, window=None):
    """(bytes, ops) the function needs for these inputs: q, out, kv_pos and
    cache_len once, plus K and V of every slot some query row can see."""
    B, T, H, D = q.shape
    K = k.shape[2]
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + pos.numel() * 4 + clen.numel() * 4
    ops = 0
    for b in range(B):
        L = int(clen[b])
        p = pos[b]
        seen = (p >= 0) & (p <= L - 1)
        nbytes += int(seen.sum()) * 2 * K * D * esz
        for t in range(T):
            vis = (p >= 0) & (p <= L - T + t)
            ops += int(vis.sum()) * H * 4 * D
    return nbytes, ops


def flash_cost(q, k, causal=True, q_offset=0):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    esz = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * esz
    pairs = sum(min(Sk, q_offset + i + 1) for i in range(Sq)) if causal else Sq * Sk
    return nbytes, B * H * pairs * 4 * D


def bound_ms(nbytes: int, ops: int, dt: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa(q, k, v, **kw):
    """One scaled_dot_product_attention call in its own (B, heads, S, D)
    layout, GQA native where this torch has it (else heads repeated)."""
    import torch

    try:
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:
        G = q.shape[1] // k.shape[1]
        return torch.nn.functional.scaled_dot_product_attention(
            q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1), **kw)


def sdpa_decode(q, k, v, clen, pos):
    """The library yardstick for decode on the same inputs (layout changes
    and the mask are made before timing)."""
    import torch

    T = q.shape[1]
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    q_pos = clen[:, None].long() - T + torch.arange(T, device=q.device)[None]
    mask = (pos[:, None, :] >= 0) & (pos[:, None, :].long() <= q_pos[:, :, None])
    mask = mask[:, None]
    return lambda: sdpa(qh, kh, vh, attn_mask=mask)


def kernel_phase(report: dict) -> dict:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    g = torch.Generator(device="cuda").manual_seed(0)
    H, K, D, S = 16, 8, 128, 512
    errs = {"decode_attention": 0.0, "flash_attention": 0.0}
    lines = []
    # ---- decode: every verify bucket, bf16; fp32; at the edges of the bf16
    # split-KV kernel (decode_wgmma_kernel): S = 200 (a ragged last tile) and
    # 250 (not a multiple of 4: a dense max_len may be any), a wrapped ring
    # with a window, rows so short that most splits see
    # nothing, an idle row (every position empty: the mean of V over all S),
    # and chunk-sized T (a chunked ingest): T*G = 80 (two warpgroups, split),
    # 128 (the serve's chunk of 64) and 200 (two query tiles); fp32 at T*G =
    # 128 and 512 (two and eight 64-row tiles of decode_kernel)
    fills = [20, 60, 140, 200, 290, 350, 420, 490]
    for T, dt, S_, fill, kw in [
            (1, "bfloat16", S, fills, {}), (2, "bfloat16", S, fills, {}),
            (3, "bfloat16", S, fills, {}), (5, "bfloat16", S, fills, {}),
            (9, "bfloat16", S, fills, {}), (5, "float32", S, fills, {}),
            (5, "bfloat16", 200, [0, 10, 60, 64, 100, 150, 190, 195], {}),
            (9, "bfloat16", 250, [9, 30, 64, 128, 129, 200, 249, 250], {}),
            (5, "bfloat16", S, [600, 1000, 40, 700, 511, 513, 2000, 90],
             {"ring": True, "window": 100}),
            (9, "bfloat16", S, [0, 1, 3, 7, 0, 2, 5, 64], {}),
            (3, "bfloat16", S, fills, {"idle": 2}),
            (40, "bfloat16", S, fills, {}), (64, "bfloat16", S, fills, {}),
            (100, "bfloat16", S, fills, {}), (64, "float32", S, fills, {}),
            (256, "float32", S, fills, {})]:
        window, idle = kw.get("window"), kw.get("idle")
        q, k, v, clen, pos = decode_case(g, 8, T, S_, H, K, D, dt, fill,
                                         ring=kw.get("ring", False))
        if idle is not None:
            pos[idle] = -1  # an idle slot: every position empty
        before = decode_attention_cuda.wgmma_launches
        got = decode_attention_cuda(q, k, v, clen, kv_positions=pos, window=window)
        if decode_attention_cuda.wgmma_launches - before != int(dt == "bfloat16"):
            fail(f"decode T={T} {dt} {kw}: took the wrong kernel")
        want = ref.decode_attention(q, k, v, clen, kv_positions=pos, window=window)
        e = check(f"decode T={T} S={S_} {dt} {kw}", got, want, dt)
        if dt == "bfloat16":
            errs["decode_attention"] = max(errs["decode_attention"], e)
        lines.append(f"decode_attention B=8 T={T} S={S_} {dt} {kw} "
                     f"({'decode_wgmma_kernel' if dt == 'bfloat16' else 'decode_kernel'}): "
                     f"max_abs_err={e:.3g}")
    # ---- flash: the prefill buckets, bf16; fp32; window + q_offset ---------
    # bf16 runs flash_wgmma_kernel (64-row tiles: S = 100 and 16 leave a
    # ragged one), fp32 flash_kernel
    for B, Sq, dt, kw in [(4, 512, "bfloat16", {}), (2, 256, "bfloat16", {}),
                          (4, 64, "bfloat16", {}), (1, 16, "bfloat16", {}),
                          (2, 100, "bfloat16", {}), (2, 256, "float32", {}),
                          (1, 64, "bfloat16", {"q_offset": 192, "window": 100}),
                          (2, 100, "bfloat16", {"q_offset": 60, "window": 70})]:
        Sk = Sq + kw.get("q_offset", 0)
        dtype = getattr(torch, dt)
        q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, Sk, K, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, Sk, K, D, generator=g, device="cuda").to(dtype)
        e = check(f"flash B={B} S={Sq} {dt} {kw}", flash_attention_cuda(q, k, v, **kw),
                  ref.flash_attention(q, k, v, **kw), dt)
        if dt == "bfloat16" and not kw:
            errs["flash_attention"] = max(errs["flash_attention"], e)
        lines.append(f"flash_attention B={B} S={Sq} {dt} {kw}: max_abs_err={e:.3g}")
    for line in lines:
        print(line)

    # ---- timing at the main path's shapes: a verify step at the depth-4
    # bucket (B=8 T=5) and a chunk step of the chunked serve (4 staging rows,
    # a chunk of 64); the cache is full
    out = {"decode_attention": decode_timing(g, 8, 5, S, H, K, D),
           "decode_attention (chunk)": decode_timing(g, 4, 64, S, H, K, D),
           "flash_attention": flash_timing(g, 4, 512, H, K, D)}
    for name, r in out.items():
        r["max_abs_err"] = max(errs[name.split()[0]], r.pop("err"))
        show_timing(name, r)
    report["kernel_checks"] = lines
    return out


def decode_timing(g, B: int, T: int, S: int, H: int, K: int, D: int) -> dict:
    """K1 (bf16) on a full cache at (B, T, S, H, K, D), on copies rotated past
    the L2: checked against its plain version, then kernel, plain version and
    SDPA timed, and the bound of this input."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    sets = copies(lambda: decode_case(g, B, T, S, H, K, D, "bfloat16", [S - T] * B,
                                      poison=False), 2 * B * S * K * D * 2)
    q, k, v, clen, pos = sets[0]
    nbytes, ops = decode_cost(q, k, clen, pos)
    e = check(f"decode timing set B={B} T={T} H={H} K={K}", decode_attention_cuda(
        q, k, v, clen, kv_positions=pos), ref.decode_attention(q, k, v, clen, kv_positions=pos),
        "bfloat16")
    lib = [sdpa_decode(*s) for s in sets]
    return {
        "shape": f"B={B} T={T} S={S} H={H} K={K} D={D} bf16",
        "ms": timed(lambda i: decode_attention_cuda(*sets[i % len(sets)][:4],
                                                    kv_positions=sets[i % len(sets)][4]), 200),
        "plain_ms": timed(lambda i: ref.decode_attention(
            *sets[i % len(sets)][:4], kv_positions=sets[i % len(sets)][4]), 20),
        "library_ms": timed(lambda i: lib[i % len(lib)](), 50),
        "bound": bound_ms(nbytes, ops, "bfloat16"), "err": e,
    }


def flash_timing(g, B: int, Sq: int, H: int, K: int, D: int) -> dict:
    """K2 (bf16, causal) at (B, Sq, H, K, D) on copies rotated past the L2:
    checked against its plain version, then kernel, plain version and SDPA
    timed, and the bound."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    fsets = copies(lambda: tuple(torch.randn(B, Sq, h, D, generator=g, device="cuda")
                                 .to(torch.bfloat16) for h in (H, K, K)),
                   2 * B * Sq * (H + 2 * K) * D)
    nbytes, ops = flash_cost(fsets[0][0], fsets[0][1])
    e = check(f"flash timing set B={B} S={Sq} H={H} K={K}", flash_attention_cuda(*fsets[0]),
              ref.flash_attention(*fsets[0]), "bfloat16")
    tsets = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in fsets]
    return {
        "shape": f"B={B} Sq=Sk={Sq} H={H} K={K} D={D} causal bf16",
        "ms": timed(lambda i: flash_attention_cuda(*fsets[i % len(fsets)]), 50),
        "plain_ms": timed(lambda i: ref.flash_attention(*fsets[i % len(fsets)]), 10),
        "library_ms": timed(lambda i: sdpa(*tsets[i % len(tsets)], is_causal=True), 50),
        "bound": bound_ms(nbytes, ops, "bfloat16"), "err": e,
    }


def show_timing(name: str, r: dict) -> None:
    was = f" (previous kernel {PREVIOUS_MS[name]} ms)" if name in PREVIOUS_MS else ""
    print(f"{name} [{r['shape']}]: kernel {r['ms']:.4f} ms{was}, plain {r['plain_ms']:.4f} "
          f"ms, sdpa {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")


def paged_case(g, B, T, dt, lens, H=16, K=8, D=128, ps=16, P=64, n_pages=4096,
               perm=None, pools=None, ride=()):
    """Paged inputs as the serving path makes them: row b holds lens[b]
    positions (the T new tokens included) on shuffled, non-contiguous pages
    with a ragged -1 tail (a length of 0 leaves the whole row unset); the
    slots past a row's length on its last page are poisoned.  A row in
    ``ride`` rides along in an admission as the engine sends it: cache_len
    lens[b] + T, so its T query positions lie past what it holds."""
    import torch

    dev, dtype = "cuda", getattr(torch, dt)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    if pools is None:
        pools = tuple(torch.randn(n_pages, ps, K, D, generator=g, device=dev).to(dtype)
                      for _ in range(2))
    if perm is None:
        perm = torch.randperm(n_pages, generator=g, device=dev).tolist()
    bt = torch.full((B, P), -1, dtype=torch.int32)
    used = 0
    for b, L in enumerate(lens):
        n = -(-L // ps)
        bt[b, :n] = torch.tensor(perm[used:used + n], dtype=torch.int32)
        used += n
        if L % ps:
            for pool, val in zip(pools, (60.0, -60.0), strict=True):
                pool[int(bt[b, n - 1]), L % ps:] = val
    clen = torch.tensor([L + T if b in ride else max(L, T) for b, L in enumerate(lens)],
                        dtype=torch.int32, device=dev)
    return q, *pools, clen, bt.to(dev)


def paged_cost(q, kp, bt, clen, window=None):
    """(bytes, ops) the function needs for these inputs: q, out, cache_len and
    the tables once, plus K and V of every position some query row can see,
    and 4*D operations per (query head, visible position) pair."""
    import numpy as np

    B, T, H, D = q.shape
    ps, K = kp.shape[1:3]
    esz = q.element_size()
    bt, clen = bt.cpu().numpy(), clen.cpu().numpy().astype(np.int64)
    S = bt.shape[1] * ps
    cum = np.zeros((B, S + 1), np.int64)
    cum[:, 1:] = np.cumsum(np.repeat(bt >= 0, ps, axis=1), axis=1)
    q_pos = clen[:, None] - T + np.arange(T)[None]
    hi = np.clip(q_pos + 1, 0, S)
    lo = np.zeros_like(hi) if window is None else np.clip(q_pos - window + 1, 0, S)
    rows = np.arange(B)[:, None]
    ops = int((cum[rows, hi] - cum[rows, lo]).sum()) * H * 4 * D
    seen = cum[np.arange(B), hi.max(1)] - cum[np.arange(B), lo.min(1)]
    nbytes = 2 * q.numel() * esz + clen.size * 4 + bt.size * 4 + int(seen.sum()) * 2 * K * D * esz
    return nbytes, ops


def gather_sdpa(q, kp, vp, clen, bt):
    """The library yardstick for paged attention, two calls: gather the rows'
    pages into a dense view, then scaled_dot_product_attention with the
    positional mask (made before timing).  No single PyTorch call computes
    attention over a paged pool."""
    import torch

    B, T = q.shape[:2]
    n_pages, ps, K, D = kp.shape
    S = bt.shape[1] * ps
    idx = bt.long().clamp(0, n_pages - 1)
    qh = q.transpose(1, 2).contiguous()
    pos = torch.arange(S, device=q.device)
    q_pos = clen[:, None].long() - T + torch.arange(T, device=q.device)[None]
    mask = (bt.repeat_interleave(ps, 1)[:, None, :] >= 0) & (pos[None, None] <= q_pos[:, :, None])
    mask = mask[:, None]

    def run():
        k, v = (x[idx].reshape(B, S, K, D).transpose(1, 2) for x in (kp, vp))
        return sdpa(qh, k, v, attn_mask=mask)
    return run


def paged_kernel_phase(report: dict) -> dict:
    """K3 against its plain version, then checked and timed at the paged serve's largest
    decode shape (B=8, T=9 over 1024 positions a row) and largest admission
    shape (B=8, T=1024 over 1024)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_paged_cuda as k3

    g = torch.Generator(device="cuda").manual_seed(3)
    err, lines = [0.0, 0.0], []  # bf16, decode/verify shapes (T <= 9) and admission
    # every row ends mid-page but one (1024); the last row is all -1 (it sees
    # nothing: the mean of V over its table).  Every bf16 call runs
    # paged_wgmma_kernel (split-KV where the query tiles do not fill the
    # card: the short rows, T + 5, and the empty one leave splits empty),
    # float32 paged_decode_kernel.  T*G = 200 leaves a ragged 64-row tile;
    # the windows start each row's range mid-page; row 1 of the "ride" cases
    # rides along past its 1024 positions (and row 3 past its 700)
    for T, dt, window, ride in [
            (1, "bfloat16", None, ()), (2, "bfloat16", None, ()), (3, "bfloat16", None, ()),
            (5, "bfloat16", None, ()), (9, "bfloat16", None, ()), (16, "bfloat16", None, ()),
            (100, "bfloat16", None, ()), (128, "bfloat16", None, ()),
            (512, "bfloat16", None, ()), (5, "float32", None, ()), (128, "float32", None, ()),
            (16, "bfloat16", 100, ()), (128, "bfloat16", 100, ()), (9, "bfloat16", 100, ()),
            (1, "bfloat16", 100, ()),
            (64, "bfloat16", None, (1, 3)), (100, "bfloat16", 37, (1, 3))]:
        lens = [T + 37, 1024, T + 300, 700, T + 5, 513, T + 130, 0]
        q, kp, vp, clen, bt = paged_case(g, 8, T, dt, lens, ride=ride)
        before = k3.wgmma_launches
        got = k3(q, kp, vp, clen, bt, window=window)
        tag = f"T={T} {dt} window={window} ride={list(ride)}"
        want_path = int(dt == "bfloat16")
        if k3.wgmma_launches - before != want_path:
            fail(f"paged {tag}: took the wrong kernel")
        want = ref.decode_attention_paged(q, kp, vp, clen, bt, window=window)
        e = check(f"paged {tag}", got, want, dt)
        if dt == "bfloat16":  # recorded without the ride-along rows, which see
            # poisoned slots (|x| = 60, where one bf16 step is 0.25)
            keep = [b for b in range(8) if b not in ride]
            err[T > 9] = max(err[T > 9], max_err(got[keep], want[keep]))
        lines.append(f"decode_attention_paged B=8 {tag} "
                     f"({'paged_wgmma_kernel' if want_path else 'paged_decode_kernel'}): "
                     f"max_abs_err={e:.3g}")
    for line in lines:
        print(line)

    out = {}
    pools = tuple(torch.randn(4096, 16, 8, 128, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
    perm = torch.randperm(4096, generator=g, device="cuda").tolist()
    for key, T, iters in (("decode", 9, (200, 20, 50)), ("admission", 1024, (20, 3, 10))):
        # 8 disjoint page sets of 8 x 64 pages: every call reads 33.6 MB of
        # the pool that the last call did not, past the 50 MB L2
        sets = [paged_case(g, 8, T, "bfloat16", [1024] * 8, perm=perm[i * 512:(i + 1) * 512],
                           pools=pools) for i in range(8)]
        nbytes, ops = paged_cost(sets[0][0], sets[0][1], sets[0][4], sets[0][3])
        # the timed shape is the path's own (admission runs K3 at T=1024): check it too
        e = check(f"paged {key} T={T} bfloat16", k3(*sets[0]),
                  ref.decode_attention_paged(*sets[0]), "bfloat16")
        err[key == "admission"] = max(err[key == "admission"], e)
        lines.append(f"decode_attention_paged B=8 T={T} bfloat16 ({key} timing set): "
                     f"max_abs_err={e:.3g}")
        print(lines[-1])
        lib = [gather_sdpa(*s) for s in sets]
        out[key] = {
            "shape": f"B=8 T={T} positions=1024 ps=16 H=16 K=8 D=128 bf16",
            "ms": timed(lambda i: k3(*sets[i % 8]), iters[0]),
            "plain_ms": timed(lambda i: ref.decode_attention_paged(*sets[i % 8]), iters[1]),
            "library_ms": timed(lambda i: lib[i % 8](), iters[2]),
            "bound": bound_ms(nbytes, ops, "bfloat16"),
        }
        r = out[key]
        was = f" (previous kernel {PREVIOUS_MS[key]} ms)" if key in PREVIOUS_MS else ""
        print(f"decode_attention_paged {key} [{r['shape']}]: kernel {r['ms']:.4f} ms{was}, "
              f"plain {r['plain_ms']:.4f} ms, gather+sdpa {r['library_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    for key, r in out.items():  # the largest bf16 error over the kernel's own checks
        r["max_abs_err"] = err[key == "admission"]
    report["paged_kernel_checks"] = lines
    return out


# -------------------------------------------------------------------- model

def model_phase(report: dict, arch: str = "qwen3-1.7b") -> None:
    """The full-width model's first 2 layers on the card (CUDA kernels) against
    the same weights on the CPU (plain versions), float32: prefill of a
    bucketed batch, a 5-token verify step, a rewind and a plain step.  Every
    float32 K1 and K3 launch must take the CUDA-core kernel (decode_kernel,
    paged_decode_kernel), none the bf16 tensor-core one.  qwen3-1.7b (two
    query heads a KV head) and llama2-7b (one: MHA, an untied head)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    gpu = build_model(cfg, "cuda")
    params = gpu.init(1)
    cpu_params = to_cpu(params)
    cpu = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, dtype=torch.int32)
    lengths = torch.tensor([64, 37], dtype=torch.int32)
    errs = []
    zero_counts()
    lg, cg = gpu.prefill(params, {"tokens": tokens.cuda(), "lengths": lengths.cuda()}, 128)
    lc, cc = cpu.prefill(cpu_params, {"tokens": tokens, "lengths": lengths}, 128)
    errs.append(max_err(lg.cpu(), lc))
    for T, accept in ((5, torch.tensor([1, 4], dtype=torch.int32)), (1, None)):
        step = torch.randint(0, cfg.vocab_size, (2, T), generator=gen, dtype=torch.int32)
        errs.append(max_err(gpu.decode_step(params, cg, step.cuda()).cpu(),
                            cpu.decode_step(cpu_params, cc, step)))
        if not torch.equal(cg["kv_pos"].cpu(), cc["kv_pos"]):
            fail("model check: kv_pos differs between the card and the CPU")
        if accept is not None:
            gpu.commit_cache(cg, cg["len"] - T, accept.cuda())
            cpu.commit_cache(cc, cc["len"] - T, accept)
    # paged: a bucketed suffix admission into shuffled pages, then a verify
    caches = [m.init_paged_cache(2, 32, 16, 128) for m in (gpu, cpu)]
    bt = torch.randperm(32, generator=gen)[:16].reshape(2, 8).to(torch.int32)
    lens, n_new = torch.tensor([0, 0], dtype=torch.int32), torch.tensor([64, 37], dtype=torch.int32)
    for c in caches:
        c["bt"].copy_(bt)
    errs.append(max_err(
        gpu.chunk_prefill(params, caches[0], tokens.cuda(), lens.cuda(), n_new.cuda()).cpu(),
        cpu.chunk_prefill(cpu_params, caches[1], tokens, lens, n_new)))
    step = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen, dtype=torch.int32)
    errs.append(max_err(gpu.decode_step(params, caches[0], step.cuda()).cpu(),
                        cpu.decode_step(cpu_params, caches[1], step)))
    launches = read_counts()
    tag = f"{arch} model check"
    print(f"{tag} (2 full-width layers, fp32, card vs CPU, dense and paged): "
          f"max_abs_err={max(errs):.3g}; launches {launches}")
    for name in ("decode_attention", "decode_attention_paged"):
        no_wgmma(launches, name, tag)
    if max(errs) > 1e-3:
        fail(f"{tag}: logits differ by {max(errs):.3g} > 1e-3")
    report["model_check_max_abs_err" if arch == "qwen3-1.7b" else
           f"{arch}_model_check_max_abs_err"] = max(errs)


def chunked_model_phase(report: dict) -> None:
    """Chunked ingest against one-shot prefill on the card, float32, with the
    full-width model's first 2 layers: a 300-token prompt ingested by the
    engine's chunk step (4 staging rows, chunks of 64, the prompt on row 1,
    the others idle), moved into a decode slot by the engine's insert, then
    one decode step; against the prompt's one-shot prefill and the same
    step.  Logits within 1e-3, and kv_pos equal over the prompt (past it a
    staging row holds only -1 or positions no query of the prompt can see).
    Every chunk step launches K1 once a layer, on decode_kernel (fp32)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.engine import ModelLane
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2, dtype="float32")
    L, R, C, S = 300, 4, 64, 512
    lane = ModelLane(cfg, build_model(cfg, "cuda").init(1), 2, S, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (L,), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32).cuda()
    one_logits, one = lane.model.prefill(lane.params, {"tokens": prompt[None]}, S)
    staging = lane.model.init_cache(R, S)
    zero_counts()
    for cur in range(0, L, C):
        n = min(C, L - cur)
        tokens = torch.zeros((R, C), dtype=torch.int32, device="cuda")
        tokens[1, :n] = prompt[cur:cur + n]
        lens, n_new = (torch.tensor([0, x, 0, 0], dtype=torch.int32, device="cuda")
                       for x in (cur, n))
        logits = lane.chunk_body(staging, tokens, lens, n_new, torch.tensor([1], device="cuda"))
    launches = read_counts()
    errs = [max_err(logits, one_logits)]
    pos = staging["kv_pos"][:, 1]
    if not torch.equal(pos[:, :L], one["kv_pos"][:, 0, :L]) or bool(
            ((pos[:, L:] >= 0) & (pos[:, L:] < L)).any()):
        fail("chunked model check: kv_pos of the chunked ingest differs from the one-shot's")
    lane.insert_body(*(t.cuda() for t in lane.rows(np.array([2, 1, 2, 2]))), staging)  # row 1
    nxt = one_logits.argmax(-1).to(torch.int32)
    errs.append(max_err(lane.decode(torch.stack([nxt, nxt]))[1],
                        lane.model.decode_step(lane.params, one, nxt[:, None])[0]))
    if not torch.equal(lane.cache["kv_pos"][:, 1, :L + 1], one["kv_pos"][:, 0, :L + 1]):
        fail("chunked model check: kv_pos differs after the move into a decode slot")
    print(f"chunked model check (2 full-width layers, fp32, {L}-token prompt in chunks of {C} "
          f"vs one-shot, then a decode step): max_abs_err={max(errs):.3g}; K1 launches "
          f"{launches['decode_attention']}")
    no_wgmma(launches, "decode_attention", "chunked model check")
    if launches["decode_attention"] != cfg.n_layers * -(-L // C):
        fail(f"chunked model check: {launches['decode_attention']} K1 launches")
    if max(errs) > 1e-3:
        fail(f"chunked model check: logits differ by {max(errs):.3g} > 1e-3")
    report["chunked_model_check_max_abs_err"] = max(errs)


# -------------------------------------------------------------------- serve

def no_wgmma(launches: dict, name: str, tag: str) -> None:
    """Fail unless the phase launched kernel ``name`` and every launch took
    its float32 CUDA-core kernel."""
    if not launches[name] or launches[f"{name}.wgmma"]:
        fail(f"{tag}: {launches[f'{name}.wgmma']} of {launches[name]} float32 {name} "
             f"launches took the bf16 tensor-core kernel")


def wgmma_only(launches: dict, tag: str, *names) -> None:
    """Fail unless every launch of each bf16 kernel ``name`` took its tensor-core kernel."""
    for name in names:
        if launches[f"{name}.wgmma"] != launches[name]:
            fail(f"{tag}: {launches[f'{name}.wgmma']} of {launches[name]} bf16 {name} "
                 f"launches took the tensor-core kernel")


def instrument(serve):
    """Count non-finite floats (logits, draft probabilities) in what every
    lane step returns, on the device (no sync): a replayed graph's outputs,
    an eager step's results.  Zero the lanes' call counts.  Returns the
    counter."""
    import torch
    from torch.utils._pytree import tree_flatten

    bad = torch.zeros((), dtype=torch.int64, device="cuda")

    def watch(f):
        def call(*args, **kw):
            out = f(*args, **kw)
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    bad.add_((~torch.isfinite(t)).sum())
            return out
        return call

    for lane in lanes(serve, "target") + lanes(serve, "draft"):
        lane.run, lane.prefill = watch(lane.run), watch(lane.prefill)
        lane.calls = {"prefill": 0, "decode": 0}
    return bad


def served(cfg, graphed: bool, **kw):
    """A StreamServe on the card, warmed up.  Graphed, the warmup captures
    every fixed-shape step's CUDA graph; eager (the comparison), every lane's
    graph cache is cleared first (``lane.graphs = None``), so each step runs
    op by op.  Returns the serve and the warmup's numbers: seconds, graphs
    captured, the graph pool's size and the peak memory."""
    import torch

    from repro_torch.api import StreamServe
    from repro_torch.core import graphs

    serve = StreamServe(cfg, device="cuda", **kw)
    if not graphed:
        for lane in lanes(serve, "target") + lanes(serve, "draft"):
            lane.graphs = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    serve.engine.warmup()
    torch.cuda.synchronize()
    pool = graphs.pool("cuda") if graphed else None
    serve.warm = {"graphed": graphed, "warmup_s": time.perf_counter() - t0,
                  "captured": captured(serve), "programs": serve.engine.jit_cache_total(),
                  "pool_gb": sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                                 if pool is not None
                                 and tuple(seg.get("segment_pool_id", ())) == tuple(pool)) / 1e9,
                  "warmup_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return serve


def captured(serve) -> int:
    """CUDA graphs the serve's lanes hold."""
    return sum(len(lane.graphs.steps) for lane in lanes(serve, "target") + lanes(serve, "draft")
               if lane.graphs is not None)


def lanes(serve, which: str) -> list:
    """The serve's target lanes, or its pairs' model-draft lanes (none
    without draft='model')."""
    pairs = serve.engine.pairs
    if which == "target":
        return [p.lane for p in pairs]
    return [p.draft.lane for p in pairs if hasattr(p.draft, "lane")]


def drive(serve, waves: dict):
    """Submit ``waves[n]`` (lists of prompts) after n engine steps and step
    until drained.  Returns (handles, submit wall per request, wall at the
    end of each tick, steps, wall seconds)."""
    import torch

    t_start = time.perf_counter()
    handles, submitted, tick_wall, steps = [], {}, {0.0: t_start}, 0
    while True:
        for prompt in waves.get(steps, ()):
            handles.append(serve.submit(prompt))
            submitted[handles[-1].request_id] = time.perf_counter()
        if steps >= max(waves) and not serve.pending:
            break
        serve.step()
        steps += 1
        tick_wall[serve.engine._now] = time.perf_counter()
        if steps > 2000:
            fail("serve: the engine did not drain")
    torch.cuda.synchronize()
    return handles, submitted, tick_wall, steps, time.perf_counter() - t_start


def serve_stats(tag, serve, bad, run, launches: dict) -> dict:
    """Hold every request to max_new_tokens in-vocabulary tokens and finite
    logits; return (and print) requests, tokens/s, TTFT and TPOT."""
    import torch

    handles, submitted, tick_wall, steps, wall = run
    arch, cfg = serve.arch, serve.config
    for h in handles:
        toks = h.request.output_tokens
        if h.state.value != "finished" or len(toks) != cfg.max_new_tokens:
            fail(f"{tag}: {h.request_id} ended {h.state.value} with {len(toks)} tokens")
        if not all(0 <= t < arch.vocab_size for t in toks):
            fail(f"{tag}: {h.request_id} emitted a token outside the vocabulary")
    if int(bad):
        fail(f"{tag}: {int(bad)} non-finite logits")
    calls = {k: sum(p.lane.calls[k] for p in serve.engine.pairs) for k in ("prefill", "decode")}
    recs = serve.monitor.completed
    ttft_s = [tick_wall[r.token_times[0]] - submitted[r.request_id] for r in recs]
    tpot_s = [(tick_wall[r.token_times[-1]] - tick_wall[r.token_times[0]])
              / (len(r.token_times) - 1) for r in recs]
    s = serve.summary()
    generated = sum(r.generated for r in recs)
    warm = getattr(serve, "warm", {})
    result = {
        **warm, "tokens": [h.request.output_tokens for h in handles],
        "captured_after_warmup": captured(serve) - warm.get("captured", 0),
        "programs_after_warmup": serve.engine.jit_cache_total() - warm.get("programs", 0),
        "requests": len(recs), "engine_steps": steps,
        "prefill_calls": calls["prefill"], "decode_calls": calls["decode"],
        "launches": launches, "wall_s": wall, "generated_tokens": generated,
        "tokens_per_s": generated / wall,
        "ttft_ticks_mean": s["ttft_mean"], "tpot_ticks_mean": s["tpot_mean"],
        "ttft_s_mean": sum(ttft_s) / len(ttft_s), "ttft_s_max": max(ttft_s),
        "tpot_s_mean": sum(tpot_s) / len(tpot_s),
        "step_s_mean": wall / steps,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "acceptance": [p.acceptance for p in serve.engine.pairs],
    }
    print(f"{tag}: {len(recs)} requests, {generated} tokens in {wall:.3f} s wall "
          f"({generated / wall:.1f} tokens/s), {steps} engine steps "
          f"({wall / steps * 1e3:.1f} ms/step); prefill calls {calls['prefill']}, "
          f"decode calls {calls['decode']}; launches {launches}")
    print(f"{tag}: TTFT mean {result['ttft_ticks_mean']:.2f} ticks = "
          f"{result['ttft_s_mean']:.3f} s, TPOT mean {result['tpot_ticks_mean']:.3f} ticks = "
          f"{result['tpot_s_mean'] * 1e3:.2f} ms; peak memory {result['peak_mem_gb']:.2f} GB")
    if warm.get("graphed"):
        print(f"{tag}: {warm['captured']} graphs captured in a {warm['warmup_s']:.2f} s warmup, "
              f"pool {warm['pool_gb']:.2f} GB, warmup peak {warm['warmup_peak_gb']:.2f} GB; after "
              f"warmup {result['captured_after_warmup']} captures, "
              f"{result['programs_after_warmup']} programs")
    return result


def twice(report: dict, key: str, phase, profile: dict = None, split=None):
    """Run a serve phase eager, then graphed, on the same weights (the eager
    run makes them), each followed by its profiled burst (``profile``: the
    arguments of profile_phase, its key suffixed "_eager" for the first) and
    its host split over a burst of ``split`` prompt lengths; hold the graphed
    serve to the eager one's tokens and launch counts, and to no capture and
    no new program after warmup.  Returns the graphed phase's (launches,
    serve) and the weights."""
    weights = {}
    for graphed in (False, True):
        launches, serve = phase(graphed, **weights)
        suffix = "" if graphed else "_eager"
        if profile is not None:
            profile_phase(serve, report, **{**profile, "key": profile["key"] + suffix})
        if split is not None:
            host_split(serve, report, key + suffix, split)
        weights = {"params": serve.engine.pairs[0].lane.params}
        if lanes(serve, "draft"):
            weights["draft_params"] = lanes(serve, "draft")[0].params
        if not graphed:
            del serve
            release()
    same_as_eager(report, key)
    return launches, serve, weights


def same_as_eager(report: dict, key: str, bucketed: bool = True) -> None:
    """The graphed serve ``report[key]`` against ``report[key + "_eager"]``:
    equal tokens and launch counts; where every shape is bucketed, nothing
    captured and no program added after warmup (a stack with SSM layers adds
    its exact prompt lengths as programs, run eagerly, as the reference
    retraces them)."""
    g, e = report[key], report[key + "_eager"]
    if g["tokens"] != e["tokens"]:
        fail(f"{key}: the graphed serve's tokens differ from the eager serve's")
    if g["launches"] != e["launches"]:
        fail(f"{key}: launches graphed {g['launches']} != eager {e['launches']}")
    if bucketed and g["captured_after_warmup"]:
        fail(f"{key}: {g['captured_after_warmup']} graphs captured after warmup")
    if bucketed and g.get("programs_after_warmup") and not key.startswith("mamba"):
        fail(f"{key}: {g['programs_after_warmup']} programs added after warmup")
    line = {m: (e[m], g[m]) for m in ("wall_s", "step_s_mean", "ttft_s_mean", "tpot_s_mean")
            if m in g}
    report.setdefault("graphed_vs_eager", {})[key] = line
    print(f"{key}: graphed tokens and launches equal the eager serve's; (eager, graphed) "
          + ", ".join(f"{m} ({a:.4g}, {b:.4g})" for m, (a, b) in line.items()))


def host_split(serve, report: dict, key: str, lens, seed=9) -> None:
    """Where a step's host time goes, on a burst that synchronises after every
    lane step, so that the parts add up to the wall: inside lane steps
    (dispatch: the ops launched one by one, or a graph's input copies and its
    replay), waiting for the device after them, and the rest (the engine's
    bookkeeping: routing, SpecuStream, drafts, KV and request state, the one
    bulk copy a step).  Per engine step, host clock."""
    import numpy as np
    import torch

    spent = {"dispatch": 0.0, "device": 0.0}

    def timed_step(f):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = f(*args, **kw)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            spent["dispatch"] += t1 - t0
            spent["device"] += time.perf_counter() - t1
            return out
        return call

    all_lanes = lanes(serve, "target") + lanes(serve, "draft")
    saved = [(lane.run, lane.prefill) for lane in all_lanes]
    for lane in all_lanes:
        lane.run, lane.prefill = timed_step(lane.run), timed_step(lane.prefill)
    rng = np.random.default_rng(seed)
    for n in lens:
        serve.submit(rng.integers(0, serve.arch.vocab_size, n).tolist())
    ticks = serve.engine._now
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve.run_until_done()
    torch.cuda.synchronize()
    wall, steps = time.perf_counter() - t0, serve.engine._now - ticks
    for lane, (run, prefill) in zip(all_lanes, saved, strict=True):
        lane.run, lane.prefill = run, prefill
    ms = {k: v / steps * 1e3 for k, v in spent.items()}
    ms.update(wall=wall / steps * 1e3, steps=steps)
    ms["bookkeeping"] = ms["wall"] - ms["dispatch"] - ms["device"]
    report.setdefault("host_split", {})[key] = ms
    print(f"host split, {key}: {ms['wall']:.2f} ms a step = dispatch {ms['dispatch']:.2f} + "
          f"device wait {ms['device']:.2f} + bookkeeping {ms['bookkeeping']:.2f} ({steps:g} steps)")


def kernel_counters():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    return {"decode_attention": da.decode_attention_cuda,
            "flash_attention": fa.flash_attention_cuda,
            "decode_attention_paged": da.decode_attention_paged_cuda,
            "ssd_scan": ssd.ssd_scan_cuda}


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = fn.wgmma_launches = 0


def read_counts() -> dict:
    """Launches per kernel, and per bf16 tensor-core path ("<name>.wgmma")."""
    counts = {name: fn.launches for name, fn in kernel_counters().items()}
    counts.update({f"{name}.wgmma": fn.wgmma_launches for name, fn in kernel_counters().items()})
    return counts


def serve_phase(report: dict, params=None, graphed=True, temperature=0.0):
    """The default serve at full width (sampled, with ``temperature`` > 0)."""
    import numpy as np
    import torch

    from repro_torch.api import ServeConfig

    cfg = ServeConfig(reduced=False, n_pairs=2, max_batch=8, max_len=512, max_new_tokens=32,
                      temperature=temperature)
    t0 = time.perf_counter()
    serve = served(cfg, graphed, **({} if params is None else {"params": params}))
    torch.cuda.synchronize()
    arch = serve.arch
    print(f"serve: {arch.name} L={arch.n_layers} d_model={arch.d_model} vocab={arch.vocab_size} "
          f"{arch.dtype}, {cfg.n_pairs} pairs x {cfg.max_batch} slots, max_len {cfg.max_len}; "
          f"init {time.perf_counter() - t0:.2f} s")
    bad = instrument(serve)
    rng = np.random.default_rng(0)
    lens = [16, 400, 24, 300, 40, 200, 64, 130, 350, 33, 100, 250]
    prompts = [rng.integers(0, arch.vocab_size, n).tolist() for n in lens]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = drive(serve, {0: prompts[:8], 3: prompts[8:]})  # a second wave joins mid-decode
    launches = read_counts()
    tag = "sampled serve" if temperature else "serve"
    result = serve_stats(tag + ("" if graphed else " (eager)"), serve, bad, run, launches)
    L, calls = arch.n_layers, result
    if launches["flash_attention"] != L * calls["prefill_calls"] or not calls["prefill_calls"]:
        fail(f"serve: flash launches {launches['flash_attention']} != {L} x "
             f"{calls['prefill_calls']} prefill calls")
    if launches["decode_attention"] != L * calls["decode_calls"] or not calls["decode_calls"]:
        fail(f"serve: decode launches {launches['decode_attention']} != {L} x "
             f"{calls['decode_calls']} decode calls")
    wgmma_only(launches, "serve", "flash_attention", "decode_attention")
    result["prompt_lens"] = lens
    report[tag.replace(" ", "_") + ("" if graphed else "_eager")] = result
    return launches, serve


def paged_serve_phase(params, report: dict, graphed=True):
    """The paged path at full width: 16 requests of 32 new tokens on 2 pairs
    (max_len 512, max_context 1024, 4096 pages of 16 a pair).  8 share a
    256-token prefix and arrive once the first of them was admitted, so the
    rest hit the radix index; 4 prompts of 600-900 tokens exceed max_len; 4
    are short and unique.  Every admission and decode step runs K3."""
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.api import ServeConfig

    cfg = ServeConfig(reduced=False, n_pairs=2, max_batch=8, max_len=512, max_new_tokens=32,
                      paged_kv=True, kv_block_size=16, max_context=1024)
    serve = served(cfg, graphed, params=params)
    arch = serve.arch
    bad = instrument(serve)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, arch.vocab_size, 256).tolist()
    shared = [prefix + rng.integers(0, arch.vocab_size, int(n)).tolist()
              for n in rng.integers(16, 97, 8)]
    long = [rng.integers(0, arch.vocab_size, int(n)).tolist() for n in (600, 700, 800, 900)]
    short = [rng.integers(0, arch.vocab_size, int(n)).tolist() for n in (12, 30, 50, 90)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = drive(serve, {0: [shared[0], *long, *short], 1: shared[1:]})
    launches = read_counts()
    result = serve_stats("paged serve" + ("" if graphed else " (eager)"), serve, bad, run,
                         launches)
    handles = run[0]
    hits = [h.request.cache_hit_tokens for h in handles]
    routing = Counter(h.request.worker_id for h in handles if list(h.request.prompt[:256]) == prefix)
    k3_calls = result["prefill_calls"] + result["decode_calls"]
    print(f"paged serve: cache_hit_tokens {sum(hits)} (per request {hits}); shared-prefix "
          f"requests per pair {dict(sorted(routing.items()))}; K3 launches "
          f"{launches['decode_attention_paged']} = {arch.n_layers} x {k3_calls} calls")
    if sum(hits) <= 0:
        fail("paged serve: no request hit the radix index")
    if launches["decode_attention_paged"] != arch.n_layers * k3_calls or not k3_calls:
        fail(f"paged serve: K3 launches {launches['decode_attention_paged']} != "
             f"{arch.n_layers} x {k3_calls} admission and decode calls")
    print(f"paged serve: K3 launches on paged_wgmma_kernel "
          f"{launches['decode_attention_paged.wgmma']} of {launches['decode_attention_paged']}")
    wgmma_only(launches, "paged serve", "decode_attention_paged")
    if not any(len(h.request.prompt) > cfg.max_len for h in handles):
        fail("paged serve: no prompt beyond max_len was served")
    result.update(cache_hit_tokens=hits, shared_prefix_routing=dict(routing),
                  prompt_lens=[len(h.request.prompt) for h in handles])
    report["paged_serve" + ("" if graphed else "_eager")] = result
    return launches, serve


def chunked_serve_phase(params, report: dict, paged=False, graphed=True):
    """Chunked prefill at full width (chunk 64, preemption on, 2 pairs x 8
    slots, max_len 512): one (4, 64) chunk step a tick a pair, each a decode
    step over the staging rows, so K1 runs 28 times a chunk step and K2
    never.  Dense: the dense serve's 12 prompts, and K1 also on every decode
    call.  Paged (max_context 1024): 8 prompts sharing a 256-token prefix
    (the first at tick 0, the rest 6 ticks later), 4 of 300-480 tokens and 4
    short; chunked ingest is private, so no prefix hit, and K3 runs on every
    decode call."""
    import numpy as np
    import torch

    from repro_torch.api import ServeConfig

    tag = "paged chunked serve" if paged else "chunked serve"
    cfg = ServeConfig(reduced=False, n_pairs=2, max_batch=8, max_len=512, max_new_tokens=32,
                      prefill_chunk=64, **({"paged_kv": True, "kv_block_size": 16,
                                            "max_context": 1024} if paged else {}))
    serve = served(cfg, graphed, params=params)
    vocab = serve.arch.vocab_size
    bad = instrument(serve)
    rng = np.random.default_rng(8 if paged else 0)
    if paged:
        prefix = rng.integers(0, vocab, 256).tolist()
        shared = [prefix + rng.integers(0, vocab, int(n)).tolist() for n in rng.integers(16, 97, 8)]
        other = [rng.integers(0, vocab, n).tolist() for n in (300, 400, 450, 480, 12, 30, 50, 90)]
        waves = {0: [shared[0], *other], 6: shared[1:]}
    else:
        lens = [16, 400, 24, 300, 40, 200, 64, 130, 350, 33, 100, 250]
        prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
        waves = {0: prompts[:8], 3: prompts[8:]}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = drive(serve, waves)
    launches = read_counts()
    result = serve_stats(tag + ("" if graphed else " (eager)"), serve, bad, run, launches)
    L, chunks, decodes = serve.arch.n_layers, result["prefill_calls"], result["decode_calls"]
    hits = sum(h.request.cache_hit_tokens for h in run[0])
    k1 = L * (chunks + (0 if paged else decodes))
    print(f"{tag}: {chunks} chunk steps, {decodes} decode calls; K1 launches "
          f"{launches['decode_attention']} (expected {k1}), K3 {launches['decode_attention_paged']}"
          f", K2 {launches['flash_attention']}; cache_hit_tokens {hits}")
    if not chunks or not decodes or launches["decode_attention"] != k1:
        fail(f"{tag}: K1 launches {launches['decode_attention']} != {k1}")
    if launches["flash_attention"] or launches["decode_attention_paged"] != L * decodes * paged:
        fail(f"{tag}: unexpected K2 or K3 launches {launches}")
    wgmma_only(launches, tag, "decode_attention", "decode_attention_paged")
    if paged and hits:
        fail(f"{tag}: chunked ingest hit {hits} tokens of the radix index")
    result.update(prompt_lens=[len(h.request.prompt) for h in run[0]], cache_hit_tokens=hits,
                  chunk_step_k1_launches=L * chunks)
    report[("paged_chunked_serve" if paged else "chunked_serve") + ("" if graphed else "_eager")] \
        = result
    return launches, serve


def preempt_phase(params, report: dict) -> None:
    """The reference bench's long-prompt trace at full width on one pair
    (benchmarks/engine_bench.py: long_prompt_trace, serve_staged): a
    480-token prompt (8 chunks of 64), one tick, then 3 prompts of 12
    tokens with a TTFT deadline of 60 ticks; once with EDF preemption at
    chunk boundaries and once without.  The shorts' TTFT p99 in ticks must
    be lower with preemption on."""
    import numpy as np

    from repro_torch.api import ServeConfig

    out = {}
    for preempt in (True, False):
        cfg = ServeConfig(reduced=False, n_pairs=1, max_batch=8, max_len=512, max_new_tokens=32,
                          prefill_chunk=64, prefill_preempt=preempt)
        serve = served(cfg, True, params=params)
        rng = np.random.default_rng(17)
        long = serve.submit(rng.integers(0, serve.arch.vocab_size, 480).tolist())
        serve.step()
        shorts = [serve.submit(rng.integers(0, serve.arch.vocab_size, 12).tolist(), slo_ttft=60.0)
                  for _ in range(3)]
        t0 = time.perf_counter()
        serve.run_until_done()
        ttft = [h.slo()["ttft"] for h in shorts]
        out[preempt] = {"shorts_ttft_ticks": ttft, "shorts_ttft_p99_ticks":
                        float(np.percentile(ttft, 99)), "long_ttft_ticks": long.slo()["ttft"],
                        "wall_s": time.perf_counter() - t0}
        print(f"preemption probe, preempt={preempt}: shorts' TTFT {ttft} ticks (p99 "
              f"{out[preempt]['shorts_ttft_p99_ticks']:.2f}), the long prompt's "
              f"{out[preempt]['long_ttft_ticks']} ticks")
        del serve
    if not out[True]["shorts_ttft_p99_ticks"] < out[False]["shorts_ttft_p99_ticks"]:
        fail("preemption probe: the shorts' TTFT p99 is not lower with preemption on")
    report["preempt_probe"] = {str(k).lower(): v for k, v in out.items()}


def pressure_phase(params, report: dict) -> None:
    """A burst of 8 requests (200-token prompts, 64 new tokens) on one pair
    whose pool of 120 pages they outgrow: with kv_evict_policy='truncate'
    every request finishes and at least one is truncated (kv_evicted)."""
    import numpy as np

    from repro_torch.api import ServeConfig

    cfg = ServeConfig(reduced=False, n_pairs=1, max_batch=8, max_len=512, max_new_tokens=64,
                      paged_kv=True, kv_block_size=16, kv_blocks=120,
                      kv_evict_policy="truncate")
    serve = served(cfg, True, params=params)
    rng = np.random.default_rng(6)
    t0 = time.perf_counter()
    handles = [serve.submit(rng.integers(0, serve.arch.vocab_size, 200).tolist())
               for _ in range(8)]
    serve.run_until_done(max_steps=2000)
    recs = serve.monitor.completed
    evicted = sum(r.kv_evicted for r in recs)
    generated = [r.generated for r in recs]
    print(f"pool pressure: {len(recs)} of {len(handles)} requests finished in "
          f"{time.perf_counter() - t0:.2f} s, {evicted} truncated (kv_evicted), generated "
          f"{generated}, pool used at the end {serve.engine.pairs[0].kv.used}")
    if len(recs) != len(handles) or any(h.state.value != "finished" for h in handles):
        fail("pool pressure: not every request finished")
    if not evicted:
        fail("pool pressure: no request was truncated")
    report["pressure"] = {"requests": len(recs), "kv_evicted": evicted, "generated": generated}


PAGED_BURST = (256 + 40, 256 + 70, 640, 16, 256 + 20, 900, 48, 256 + 90)


PROFILE_LENS = (16, 400, 24, 300, 40, 200, 64, 130)


def profile_phase(serve, report: dict, key="profile", lens=PROFILE_LENS,
                  seed=1, split=False) -> None:
    """Where the time goes.  The same burst of 8 requests runs twice through
    the same server (after the launch counts were read): once plain, timed
    on the host clock, and once under torch.profiler recording CUDA activity
    only.  Device busy time is the sum of kernel and copy durations on the
    one stream; the busy share is that over the plain burst's wall time
    (greedy decoding does the same device work both times).  A paged burst
    has 4 prompts that share a 256-token prefix, 2 beyond max_len and 2
    short; its profiled repeat draws new tokens of the same lengths, since
    the same prompts would hit the first burst's resident pages.  With
    ``split`` the burst's prefill calls are then profiled alone (same prompt
    lengths, new tokens; admission's insert and sampling left out): their
    device time against the burst's is prefill's share, the rest decode's."""
    import re
    from collections import Counter

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    paged, vocab = serve.config.paged_kv, serve.arch.vocab_size

    def burst(s):
        rng = np.random.default_rng(s)
        prefix = rng.integers(0, vocab, 256).tolist() if paged else []
        for n in lens:
            head = prefix if 256 < n < 512 else []
            serve.submit(head + rng.integers(0, vocab, n - len(head)).tolist())
        t0 = time.perf_counter()
        serve.run_until_done()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = burst(seed)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_profiled = burst(seed + paged)  # a paged repeat would hit the first's pages
    by_name: Counter = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    if split:
        rng = np.random.default_rng(seed + 1)
        prompts = [torch.tensor(rng.integers(0, vocab, (1, n)), dtype=torch.int32, device="cuda")
                   for n in lens]
        with profile(activities=[ProfilerActivity.CUDA]) as alone:
            for tokens in prompts:
                serve.engine.pairs[0].lane.prefill({"tokens": tokens})
            torch.cuda.synchronize()
    # first match wins (paged_* before decode_*); K3 on one warpgroup (T*G <=
    # 64: every decode and verify call, and admissions of up to 32 tokens)
    # apart from K3 on two (the longer admissions)
    groups = ((r"ssd_kernel|ssd_wgmma_kernel", "ssd_scan"),
              (r"paged_wgmma_kernel<\d+, ?1>", "decode_attention_paged (one warpgroup)"),
              (r"paged_wgmma_kernel", "decode_attention_paged (two warpgroups)"),
              (r"paged_decode_kernel", "decode_attention_paged (fp32)"),
              (r"decode_wgmma_kernel|decode_kernel", "decode_attention"),
              (r"flash_kernel|flash_wgmma_kernel", "flash_attention"),
              (r"gemm|nvjet|xmma|cutlass", "matmul"), (r"memcpy|memset", "copies"))
    by_group: Counter = Counter()
    for name, ms in by_name.items():
        by_group[next((g for k, g in groups if re.search(k, name.lower())), "other")] += ms
    busy = sum(by_group.values())
    report[key] = {
        "burst_wall_ms": wall * 1e3, "burst_wall_profiled_ms": wall_profiled * 1e3,
        "device_busy_ms": busy, "busy_share": busy / (wall * 1e3),
        "device_ms_by_group": dict(by_group.most_common()),
        "top_kernels_ms": dict(by_name.most_common(12))}
    if split:
        prefill_ms = sum(e.time_range.elapsed_us() for e in alone.events()
                         if e.device_type == DeviceType.CUDA) / 1e3
        report[key]["device_ms_by_phase"] = {"prefill": prefill_ms, "decode": busy - prefill_ms}
    if not busy:
        fail(f"{key}: the profiler recorded no device events")
    print(f"{key}: burst of 8 requests {wall * 1e3:.1f} ms wall ({wall_profiled * 1e3:.1f} ms "
          f"profiled), device busy {busy:.1f} ms = {busy / (wall * 1e3):.1%} of the wall")
    print(f"{key}: device time " + ", ".join(
        f"{g} {ms / busy:.1%}" for g, ms in by_group.most_common()))
    for name, ms in by_name.most_common(6):
        print(f"  {ms:9.2f} ms  {name[:110]}")
    if split:
        print(f"{key}: device time of the burst's {len(lens)} prefill calls alone "
              f"{prefill_ms:.1f} ms = {prefill_ms / busy:.1%} of the burst's; decode and the "
              f"rest {busy - prefill_ms:.1f} ms = {1 - prefill_ms / busy:.1%}")


# ------------------------------------------------------- llama2-7b (the paper)

# the paper serve's burst: 20 prompts of 16-1500 tokens, 16 at tick 0 and 4
# two steps later; the bucketed prefill reaches its 2048 bucket
LLAMA_LENS = [16, 1500, 24, 900, 40, 600, 64, 300, 1200, 33, 100, 250, 700, 48, 1024, 200,
              128, 400, 80, 1400]
PAPER_NEW_TOKENS = 64  # the paper preset's 512 new tokens cut to fit the time limit


def llama_kernel_phase(report: dict) -> dict:
    """K1, K2 and K3 at one query head per KV head (llama2-7b's MHA, H = K =
    32, D = 128), held against their plain versions: K1 at the paper serve's
    cache (B=16, S=2048) for T = 1 (the draft's proposals), the verify
    buckets' T = 2, 3, 5, 9 and an unbucketed T = 7, rows filled from 0 to
    2048 with stale slots poisoned and one idle row, bf16 and one fp32 case;
    K2 at the largest prefill bucket (B=4, S=2048) and a ragged length; K3
    decode over shuffled pages.  Every bf16 call must take the tensor-core
    kernel.  Then K1 (full cache, T = 9 and 1) and K2 (B=4, S=2048) timed."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda as k1
    from repro_torch.kernels.decode_attention import decode_attention_paged_cuda as k3
    from repro_torch.kernels.flash_attention import flash_attention_cuda as k2

    g = torch.Generator(device="cuda").manual_seed(18)
    B, S, H, D = 16, 2048, 32, 128
    err, lines = {"decode_attention": 0.0, "flash_attention": 0.0}, []
    fills = [int(f) for f in np.linspace(0, S, B)]

    def held(tag, name, fn, got_args, want, dt):
        before = fn.wgmma_launches
        got = fn(*got_args[0], **got_args[1])
        if fn.wgmma_launches - before != int(dt == "bfloat16"):
            fail(f"G=1 {tag}: took the wrong kernel")
        e = check(f"G=1 {tag}", got, want(), dt)
        if dt == "bfloat16":
            err[name] = max(err.get(name, 0.0), e)
        lines.append(f"G=1 {tag}: max_abs_err={e:.3g}")
        print(lines[-1])

    for T, dt in ((1, "bfloat16"), (2, "bfloat16"), (3, "bfloat16"), (5, "bfloat16"),
                  (9, "bfloat16"), (7, "bfloat16"), (5, "float32")):
        q, k, v, clen, pos = decode_case(g, B, T, S, H, H, D, dt, fills)
        pos[3] = -1  # an idle slot: every position empty
        held(f"decode_attention B={B} T={T} S={S} H=K={H} {dt}", "decode_attention", k1,
             ((q, k, v, clen), {"kv_positions": pos}),
             lambda: ref.decode_attention(q, k, v, clen, kv_positions=pos), dt)
    for Bf, Sq in ((4, 2048), (2, 1500)):
        q, k, v = (torch.randn(Bf, Sq, H, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        held(f"flash_attention B={Bf} S={Sq} H=K={H} bfloat16", "flash_attention", k2,
             ((q, k, v), {}), lambda: ref.flash_attention(q, k, v), "bfloat16")
    for T in (1, 9):
        args = paged_case(g, B, T, "bfloat16", [max(f, 1) if b % 5 else 0
                                                for b, f in enumerate(fills)],
                          H=H, K=H, D=D, P=S // 16)
        held(f"decode_attention_paged B={B} T={T} H=K={H} bfloat16", "decode_attention_paged",
             k3, (args, {}), lambda: ref.decode_attention_paged(*args), "bfloat16")
    out = {"decode_attention (llama2 verify)": decode_timing(g, B, 9, S, H, H, D),
           "decode_attention (llama2 draft)": decode_timing(g, B, 1, S, H, H, D),
           "flash_attention (llama2)": flash_timing(g, 4, S, H, H, D)}
    for name, r in out.items():
        r["max_abs_err"] = max(err[name.split()[0]], r.pop("err"))
        show_timing(name, r)
    report["llama2_kernel_checks"] = lines
    return out


@contextlib.contextmanager
def acceptance_counted():
    """Record (accepted, proposed) draft tokens over the active rows of
    every verify step the port's engine takes inside the block, from what
    the step returns (a replayed graph's outputs), on the device (no sync);
    yields the list."""
    import torch

    from repro_torch.core.engine import StreamPair

    seen, verify = [], StreamPair._verify_step

    def counted(pair, pending, draft, draft_q, active, depth=None):
        res, host = verify(pair, pending, draft, draft_q, active, depth)
        d = (torch.full_like(res.n_accepted, draft.shape[1]) if depth is None
             else depth.to(active.device).long())
        seen.append(torch.stack([(res.n_accepted * active).sum(), (d * active).sum()]))
        return res, host

    StreamPair._verify_step = counted
    try:
        yield seen
    finally:
        StreamPair._verify_step = verify


def acceptance(seen: list) -> float:
    import torch

    accepted, proposed = torch.stack(seen).sum(0).tolist() if seen else (0, 0)
    return accepted / max(proposed, 1)


def paper_serve_phase(report: dict, params=None, draft_params=None, graphed=True):
    """The paper's §4 operating point at full width: StreamServe(ServeConfig.
    paper_stream_pairs("llama2-7b", draft="model")) on seeded random weights,
    2 stream pairs x 16 slots, a 2048-token dense cache, bucketed fused
    prefill, FlowGuard and EDF, the 2-layer model draft with SpecuStream
    per-row depths and depth-bucketed verify; 512 new tokens cut to
    PAPER_NEW_TOKENS.  K2 runs on every prefill of both lanes (32 and 2
    launches a call) and K1 on every target decode and draft proposal (32
    and 2), all on the tensor-core kernels."""
    import numpy as np
    import torch

    from repro_torch.api import ServeConfig

    cfg = ServeConfig.paper_stream_pairs("llama2-7b", draft="model",
                                         max_new_tokens=PAPER_NEW_TOKENS)
    t0 = time.perf_counter()
    serve = served(cfg, graphed, **({} if params is None else
                                    {"params": params, "draft_params": draft_params}))
    torch.cuda.synchronize()
    arch, draft = serve.arch, cfg.build_draft_arch_config()
    print(f"paper serve: {arch.name} L={arch.n_layers} d_model={arch.d_model} heads "
          f"{arch.n_heads}/{arch.n_kv_heads} vocab={arch.vocab_size} {arch.dtype}, draft "
          f"{draft.name} L={draft.n_layers}, {cfg.n_pairs} pairs x {cfg.max_batch} slots, "
          f"max_len {cfg.max_len}; init {time.perf_counter() - t0:.2f} s")
    bad = instrument(serve)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, arch.vocab_size, n).tolist() for n in LLAMA_LENS]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with acceptance_counted() as seen:
        run = drive(serve, {0: prompts[:16], 2: prompts[16:]})
    launches = read_counts()
    result = serve_stats("paper serve" + ("" if graphed else " (eager)"), serve, bad, run,
                         launches)
    split = {}
    for which, n in (("target", arch.n_layers), ("draft", draft.n_layers)):
        for call, kernel in (("decode", "decode_attention"), ("prefill", "flash_attention")):
            split[f"{kernel}.{which}"] = n * sum(ln.calls[call] for ln in lanes(serve, which))
    result.update(launch_split=split, draft_acceptance=acceptance(seen), prompt_lens=LLAMA_LENS,
                  draft_calls={c: sum(ln.calls[c] for ln in lanes(serve, "draft"))
                               for c in ("prefill", "decode")})
    print(f"paper serve: K1 launches {launches['decode_attention']} = target "
          f"{split['decode_attention.target']} + draft {split['decode_attention.draft']}, K2 "
          f"{launches['flash_attention']} = target {split['flash_attention.target']} + draft "
          f"{split['flash_attention.draft']}; draft acceptance {result['draft_acceptance']:.4f}")
    for kernel in ("decode_attention", "flash_attention"):
        parts = (split[f"{kernel}.target"], split[f"{kernel}.draft"])
        if launches[kernel] != sum(parts) or not all(parts):
            fail(f"paper serve: {kernel} launches {launches[kernel]} != target + draft {parts}")
    wgmma_only(launches, "paper serve", "decode_attention", "flash_attention")
    if launches["decode_attention_paged"] or launches["ssd_scan"]:
        fail(f"paper serve: unexpected launches {launches}")
    report["paper_serve" + ("" if graphed else "_eager")] = result
    return launches, serve


def ablation_phase(params, draft_params, report: dict, graphed=True) -> None:
    """The paper's Table 8/9 switches on the same weights and operating
    point: round-robin routing, single-depth verify without verify buckets,
    a fixed depth of 4.  Requests alternate pairs and every target verify
    step runs K1 at T = 5, unpadded; the draft proposes at T = 1."""
    import numpy as np

    from repro_torch.api import ServeConfig

    cfg = ServeConfig.paper_stream_pairs(
        "llama2-7b", draft="model", router="roundrobin", per_row_depth=False,
        verify_buckets=None, spec_policy="fixed", fixed_depth=4, max_new_tokens=32)
    serve = served(cfg, graphed, params=params, draft_params=draft_params)
    warm = captured(serve)
    widths = {"target": set(), "draft": set()}
    for which in widths:  # the width of every decode program a step runs
        for lane in lanes(serve, which):
            def run(programs, *args, f=lane.run, w=widths[which], **kw):
                w.update(shape[0] for name, shape in programs if name == "lane_decode")
                return f(programs, *args, **kw)
            lane.run = run
    rng = np.random.default_rng(12)
    zero_counts()
    handles = [serve.submit(rng.integers(0, serve.arch.vocab_size, n).tolist())
               for n in (40, 700, 120, 1500, 16, 300)]
    t0 = time.perf_counter()
    serve.run_until_done()
    launches = read_counts()
    pairs = [h.request.worker_id for h in handles]
    tag = "ablation serve" + ("" if graphed else " (eager)")
    print(f"{tag} (round-robin, single depth 4, no verify buckets): {len(handles)} "
          f"requests in {time.perf_counter() - t0:.2f} s, pairs {pairs}, decode widths "
          f"{ {k: sorted(v) for k, v in widths.items()} }, launches {launches}; graphs captured "
          f"after warmup (unbucketed verify: each new width) {captured(serve) - warm}")
    if any(h.state.value != "finished" or len(h.result()) != cfg.max_new_tokens
           for h in handles):
        fail("ablation serve: not every request finished")
    if pairs != [0, 1] * 3 or widths != {"target": {5}, "draft": {1}}:
        fail("ablation serve: requests did not alternate pairs or K1 ran at another width")
    wgmma_only(launches, "ablation serve", "decode_attention", "flash_attention")
    report["ablation_serve" + ("" if graphed else "_eager")] = {
        "pairs": pairs, "launches": launches, "tokens": [h.result() for h in handles],
        "decode_widths": {k: sorted(v) for k, v in widths.items()},
        "captured_after_warmup": captured(serve) - warm}


def self_draft_phase(report: dict) -> None:
    """llama2-7b's first 2 layers at full width in fp32 as their own draft
    (draft_cfg and draft_params the target's, all its layers), 12 requests of
    32 new tokens on 2 pairs x 8 slots: greedy verify must give the tokens of
    decoding without a draft.  The draft protocol is the reference's, which
    never ingests the k-th proposal, so a step that accepts all k leaves the
    draft a token short (ROADMAP §3) and acceptance stays below 1; a draft
    that also ingests its last proposal must accept >= 0.9 and give the same
    tokens.  The one check on the card of the draft lane's propose, commit
    and rollback.  The engines are graphed without a warmup, so each step's
    graph is captured at its first call; the model draft also runs eager, on
    the same tokens and acceptance."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.engine import EngineConfig, ModelLaneDraft, PipeServeEngine
    from repro_torch.models import build_model
    from repro_torch.serving.request import Request, SamplingParams

    class IngestLast(ModelLaneDraft):  # the draft lane's decode and commit, graphed
        def propose(self, pair, k):
            toks, q = super().propose(pair, k)
            self.lane.decode(toks[:, -1:].int())
            return toks, q

        def on_commit(self, pair, accept_idx, k):
            self.lane.commit(k + 1, accept_idx)

    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=2, dtype="float32")
    params = build_model(cfg, "cuda").init(1)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (16, 400, 24, 300, 40, 200, 64, 130, 350, 33, 100, 250)]

    def run(draft, cls=ModelLaneDraft, graphed=True):
        engine = PipeServeEngine(cfg, params, n_pairs=2, device="cuda", draft_cfg=cfg,
                                 draft_params=params,
                                 econf=EngineConfig(max_batch=8, max_len=512, draft=draft))
        for pair in engine.pairs:
            if draft == "model":
                pair.draft.__class__ = cls
            if not graphed:
                pair.lane.graphs = None
                if draft == "model":
                    pair.draft.lane.graphs = None
        reqs = [Request(prompt=p, params=SamplingParams(max_new_tokens=32)) for p in prompts]
        with acceptance_counted() as seen:
            for r in reqs:
                engine.submit(r)
            engine.run_until_done()
        return [r.output_tokens for r in reqs], acceptance(seen)

    eager = run("model", graphed=False)  # the draft lane's steps, eager
    zero_counts()
    plain, _ = run("none")
    mirrored, ref_protocol = run("model")
    level, ingest_last = run("model", IngestLast)
    torch.cuda.synchronize()
    launches = read_counts()
    if eager != (mirrored, ref_protocol):
        fail("self-draft check: the graphed engine's tokens or acceptance differ from eager")
    same = plain == mirrored == level
    print(f"self-draft check (llama2-7b, 2 full-width layers, fp32): acceptance "
          f"{ref_protocol:.4f} with the reference's draft protocol, {ingest_last:.4f} with the "
          f"draft ingesting its last proposal; tokens equal to decoding without a draft: {same}")
    for name in ("decode_attention", "flash_attention"):
        no_wgmma(launches, name, "self-draft check")
    if not same or ingest_last < 0.9:
        fail("self-draft check: tokens differ from plain decoding or acceptance < 0.9")
    report["self_draft"] = {"acceptance_reference_protocol": ref_protocol,
                            "acceptance_ingest_last": ingest_last, "tokens_equal": same}


# --------------------------------------------------------------- SSM (mamba2)

SSD_CHECKS = [  # B, S, H, P, G, N, dtype, initial state
    (1, 400, 80, 64, 1, 128, "bfloat16", False),  # the serve shape
    (1, 400, 80, 64, 1, 128, "float32", False),
    (2, 300, 16, 64, 2, 128, "bfloat16", True),   # 2 groups, ragged tail, initial state
    (2, 300, 16, 64, 2, 128, "float32", True),
    (1, 5, 80, 64, 1, 128, "bfloat16", False),    # shorter than 8
    (2, 130, 8, 32, 2, 64, "float32", True),
    (1, 48, 16, 32, 4, 16, "float32", True),      # 4 groups of 4 heads
    (1, 1000, 80, 64, 1, 128, "bfloat16", False),  # 16 chunks, decay far below e^-100
    (1, 64, 80, 64, 1, 128, "bfloat16", False),    # one chunk
    (1, 65, 80, 64, 1, 128, "bfloat16", False),    # one chunk and one row: 2 blocks
    (1, 2048, 80, 64, 1, 128, "bfloat16", False),  # 32 chunks: 4 a block
    (2, 300, 16, 64, 4, 128, "bfloat16", True),    # 4 groups of 4 heads
]


def ssd_case(g, B, S, H, P, G, N, dt, init=False):
    """SSD-scan inputs as the model makes them: x, B and C are strided views
    of one conv output (B, S, H*P + 2*G*N) in the model dtype; dt is the
    softplus of a projection plus the init's dt_bias (dt ~0.001-0.1) and A =
    -exp(A_log) of the init (-1 to -16), both fp32; an fp32 initial state
    when asked."""
    import torch

    dev, d_in = "cuda", H * P
    xbc = (torch.randn(B, S, d_in + 2 * G * N, generator=g, device=dev) * 0.5).to(
        getattr(torch, dt))
    bias = torch.log(torch.expm1(torch.linspace(1e-3, 0.1, H, device=dev)))
    dtv = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g, device=dev) * 0.5 + bias)
    s0 = torch.randn(B, H, P, N, generator=g, device=dev) * 0.2 if init else None
    return (xbc[..., :d_in].reshape(B, S, H, P), dtv, -torch.linspace(1.0, 16.0, H, device=dev),
            xbc[..., d_in:d_in + G * N].reshape(B, S, G, N),
            xbc[..., d_in + G * N:].reshape(B, S, G, N), s0)


def ssd_cost(x, Bm, s0, chunk=64):
    """(bytes, ops) of one scan: x, dt, A, B, C (and the initial state) read
    once, y and the final state written once; the operations of the chunked
    dual form at the kernel's 64-row chunks (C.B per group, the causal
    intra-chunk product, the inter-chunk term and the state update)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    esz = x.element_size()
    nbytes = 2 * x.numel() * esz + 2 * Bm.numel() * esz + B * S * H * 4 + H * 4 \
        + (2 if s0 is not None else 1) * B * H * P * N * 4
    ops = 0
    for c0 in range(0, S, chunk):
        c = min(chunk, S - c0)
        ops += 2 * c * c * N * G + c * (c + 1) * P * H + 4 * c * P * N * H
    return nbytes, B * ops


def ssd_kernel_phase(report: dict) -> dict:
    """K4 against its plain version on SSD_CHECKS (y and final state; bf16 on
    ssd_wgmma_kernel, fp32 on ssd_kernel), then checked and timed at the
    serve shape on views rotated past the L2."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    g = torch.Generator(device="cuda").manual_seed(4)
    err, lines = 0.0, []
    for B, S, H, P, G, N, dt, init in SSD_CHECKS:
        x, dtv, A, Bm, C, s0 = ssd_case(g, B, S, H, P, G, N, dt, init)
        before = ssd_scan_cuda.wgmma_launches
        y, sf = ssd_scan_cuda(x, dtv, A, Bm, C, initial_state=s0)
        kernel = "ssd_wgmma_kernel" if dt == "bfloat16" else "ssd_kernel"
        tag = f"ssd_scan B={B} S={S} H={H} P={P} G={G} N={N} {dt} init={init} ({kernel})"
        if ssd_scan_cuda.wgmma_launches - before != int(dt == "bfloat16"):
            fail(f"{tag}: took the wrong kernel")
        wy, ws = ref.ssd_scan(x, dtv, A, Bm, C, chunk=256, initial_state=s0)
        e = max(check(tag, y, wy, dt, SSD_TOL), check(tag + " state", sf, ws, dt, SSD_TOL))
        if dt == "bfloat16":
            err = max(err, e)
        lines.append(f"{tag}: max_abs_err={e:.3g}")
        print(lines[-1])
    make = lambda: ssd_case(g, 1, 400, 80, 64, 1, 128, "bfloat16")  # noqa: E731
    sets = copies(make, 400 * (80 * 64 * 2 + 256 * 2 + 80 * 4))
    nbytes, ops = ssd_cost(sets[0][0], sets[0][3], None)
    wy, ws = ref.ssd_scan(*sets[0][:5], chunk=256)
    y, sf = ssd_scan_cuda(*sets[0][:5])
    e = max(check("ssd_scan timing set", y, wy, "bfloat16", SSD_TOL),
            check("ssd_scan timing set state", sf, ws, "bfloat16", SSD_TOL))
    err = max(err, e)
    out = {"shape": "B=1 S=400 H=80 P=64 G=1 N=128 bf16 (strided views)",
           "ms": timed(lambda i: ssd_scan_cuda(*sets[i % len(sets)][:5]), 200),
           "plain_ms": timed(lambda i: ref.ssd_scan(*sets[i % len(sets)][:5], chunk=256), 20),
           "library_ms": None, "bound": bound_ms(nbytes, ops, "bfloat16"), "max_abs_err": err}
    print(f"ssd_scan [{out['shape']}]: kernel {out['ms']:.4f} ms (previous kernel "
          f"{PREVIOUS_MS['ssd_scan']} ms), plain {out['plain_ms']:.4f} ms, no single PyTorch "
          f"call, bound {out['bound'][0]:.4f} ms ({out['bound'][1]})")
    report["ssd_kernel_checks"] = lines
    return out


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def mamba_model_phase(report: dict) -> None:
    """mamba2-2.7b's first 2 layers at full width on the card (K4) against the
    same weights on the CPU (plain versions), float32: an exact-shape prefill
    of 2 rows of 300 tokens, a 5-token verify, a per-row commit and a plain
    step; logits and the committed SSM state.  Every K4 launch must take the
    CUDA-core kernel (ssd_kernel)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2, dtype="float32")
    gpu, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    params = gpu.init(1)
    cpu_params = to_cpu(params)
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), generator=gen, dtype=torch.int32)
    zero_counts()
    lg, cg = gpu.prefill(params, {"tokens": tokens.cuda()}, 512)
    lc, cc = cpu.prefill(cpu_params, {"tokens": tokens}, 512)
    errs = [max_err(lg.cpu(), lc)]
    for T, accept in ((5, torch.tensor([1, 4], dtype=torch.int32)), (1, None)):
        step = torch.randint(0, cfg.vocab_size, (2, T), generator=gen, dtype=torch.int32)
        errs.append(max_err(gpu.decode_step(params, cg, step.cuda()).cpu(),
                            cpu.decode_step(cpu_params, cc, step)))
        if accept is not None:
            gpu.commit_cache(cg, cg["len"] - T, accept.cuda())
            cpu.commit_cache(cc, cc["len"] - T, accept)
            errs.append(max_err(cg["state"].cpu(), cc["state"]))
    launches = read_counts()
    print(f"mamba2 model check (2 full-width layers, fp32, card vs CPU): "
          f"max_abs_err={max(errs):.3g}; K4 launches {launches['ssd_scan']}, on "
          f"ssd_wgmma_kernel {launches['ssd_scan.wgmma']}")
    no_wgmma(launches, "ssd_scan", "mamba2 model check")
    if max(errs) > 1e-3:
        fail(f"mamba2 model check: logits or state differ by {max(errs):.3g} > 1e-3")
    report["mamba_model_check_max_abs_err"] = max(errs)


def mamba_serve_phase(report: dict, params=None, graphed=True):
    """mamba2-2.7b at full width on 2 pairs: the dense serve's 12 prompts of
    16-400 tokens, 32 new tokens each.  Every admission is its own exact-shape
    prefill call, which runs K4 once per layer."""
    import numpy as np
    import torch

    from repro_torch.api import ServeConfig

    cfg = ServeConfig(arch="mamba2-2.7b", reduced=False, n_pairs=2, max_batch=8, max_len=512,
                      max_new_tokens=32)
    t0 = time.perf_counter()
    serve = served(cfg, graphed, **({} if params is None else {"params": params}))
    torch.cuda.synchronize()
    arch = serve.arch
    print(f"mamba2 serve: {arch.name} L={arch.n_layers} d_model={arch.d_model} vocab="
          f"{arch.vocab_size} {arch.dtype}, {cfg.n_pairs} pairs x {cfg.max_batch} slots; "
          f"init {time.perf_counter() - t0:.2f} s")
    bad = instrument(serve)
    rng = np.random.default_rng(7)
    lens = [16, 400, 24, 300, 40, 200, 64, 130, 350, 33, 100, 250]
    prompts = [rng.integers(0, arch.vocab_size, n).tolist() for n in lens]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = drive(serve, {0: prompts[:8], 3: prompts[8:]})
    launches = read_counts()
    result = serve_stats("mamba2 serve" + ("" if graphed else " (eager)"), serve, bad, run,
                         launches)
    L, n_pre = arch.n_layers, result["prefill_calls"]
    print(f"mamba2 serve: K4 launches {launches['ssd_scan']} = {L} x {n_pre} prefill calls, "
          f"on ssd_wgmma_kernel {launches['ssd_scan.wgmma']}")
    if n_pre != len(prompts) or launches["ssd_scan"] != L * n_pre:
        fail(f"mamba2 serve: {launches['ssd_scan']} K4 launches, {n_pre} prefill calls: "
             f"expected one call per request and {L} launches per call")
    wgmma_only(launches, "mamba2 serve", "ssd_scan")
    if not result["decode_calls"] or any(n for k, n in launches.items()
                                         if not k.startswith("ssd_scan")):
        fail(f"mamba2 serve: unexpected launches {launches} or no decode call")
    result["prompt_lens"] = lens
    report["mamba_serve" + ("" if graphed else "_eager")] = result
    return launches, serve


def release() -> None:
    """Free a finished phase's device memory before the next one measures its
    peak: the instrumented lane methods form reference cycles (closures over
    bound methods stored on the lane), which only the collector breaks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("run from the root of a checkout (src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    report: dict = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["ptxas"] = {n: [ln for ln in log.splitlines() if "ptxas info" in ln
                           and ("registers" in ln or "spill" in ln)] for n, log in logs.items()}
    print(f"built {sorted(logs) or 'nothing (up to date)'} in {report['build_s']:.1f} s")
    for name, info in report["ptxas"].items():
        for ln in info:
            if "Used" in ln:
                print(f"  {name}: {ln.split('ptxas info    :')[-1].strip()}")

    tensor_core_sass(report)
    timing = kernel_phase(report)
    paged_timing = paged_kernel_phase(report)
    model_phase(report)
    chunked_model_phase(report)
    launches, serve, w = twice(report, "serve", lambda g, **w: serve_phase(report, graphed=g, **w),
                               profile={"key": "profile"}, split=PROFILE_LENS)
    params = w["params"]  # the same weights serve the rest
    del serve
    release()
    twice(report, "sampled_serve", lambda g, **w: serve_phase(report, params, g, temperature=1.0))
    release()
    _, serve, _ = twice(report, "chunked_serve",
                        lambda g, **w: chunked_serve_phase(params, report, graphed=g),
                        profile={"key": "chunked_profile", "seed": 4})
    del serve
    release()
    preempt_phase(params, report)
    release()
    paged_launches, serve, _ = twice(report, "paged_serve",
                                     lambda g, **w: paged_serve_phase(params, report, g),
                                     profile={"key": "paged_profile", "lens": PAGED_BURST,
                                              "seed": 2})
    del serve
    release()
    pressure_phase(params, report)
    release()
    _, serve, _ = twice(report, "paged_chunked_serve",
                        lambda g, **w: chunked_serve_phase(params, report, True, g))
    del serve, params
    release()
    llama_timing = llama_kernel_phase(report)
    model_phase(report, "llama2-7b")
    release()
    paper_launches, serve, w = twice(
        report, "paper_serve", lambda g, **w: paper_serve_phase(report, graphed=g, **w),
        profile={"key": "paper_profile", "lens": LLAMA_LENS[:8], "seed": 5}, split=LLAMA_LENS[:8])
    del serve
    release()
    for graphed in (False, True):
        ablation_phase(w["params"], w["draft_params"], report, graphed)
        release()
    same_as_eager(report, "ablation_serve", bucketed=False)
    del w
    release()
    self_draft_phase(report)
    release()
    ssd_timing = ssd_kernel_phase(report)
    mamba_model_phase(report)
    mamba_launches, serve, _ = twice(report, "mamba_serve",
                                     lambda g, **w: mamba_serve_phase(report, graphed=g, **w),
                                     profile={"key": "mamba_profile", "seed": 3, "split": True})
    del serve
    release()

    def entry(name, kernel, r, n, was):
        return {"name": name, "kernel": kernel, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name.split()[0]}.cu",
                "replaces": REPLACES[name.split()[0]], "launches": n,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"], "shape": r["shape"],
                "previous_ms": PREVIOUS_MS.get(was)}

    # launches: K1 and K2 from the dense serve, K1 at the chunk shape from the
    # chunked serve's chunk steps, K3 from the paged serve (its decode/verify
    # and admission calls apart, 28 launches a call), K4 from the mamba2
    # serve; at one query head per KV head, K1 from the paper serve's target
    # lanes (verify) and draft lanes (proposals), K2 from both lanes' prefills
    ps_calls = report["paged_serve"]
    k3_admit = paged_launches["decode_attention_paged"] * ps_calls["prefill_calls"] // (
        ps_calls["prefill_calls"] + ps_calls["decode_calls"])
    kernels = [entry("decode_attention", "decode_wgmma_kernel", timing["decode_attention"],
                     launches["decode_attention"], "decode_attention"),
               entry("decode_attention (chunk)", "decode_wgmma_kernel",
                     timing["decode_attention (chunk)"],
                     report["chunked_serve"]["chunk_step_k1_launches"], None),
               entry("flash_attention", "flash_wgmma_kernel", timing["flash_attention"],
                     launches["flash_attention"], "flash_attention"),
               entry("decode_attention_paged", "paged_wgmma_kernel", paged_timing["decode"],
                     paged_launches["decode_attention_paged"] - k3_admit, "decode"),
               entry("decode_attention_paged (admission)", "paged_wgmma_kernel",
                     paged_timing["admission"], k3_admit, "admission"),
               entry("ssd_scan", "ssd_wgmma_kernel", ssd_timing, mamba_launches["ssd_scan"],
                     "ssd_scan")]
    split = report["paper_serve"]["launch_split"]
    kernels += [entry("decode_attention (llama2 verify)", "decode_wgmma_kernel",
                      llama_timing["decode_attention (llama2 verify)"],
                      split["decode_attention.target"], None),
                entry("decode_attention (llama2 draft)", "decode_wgmma_kernel",
                      llama_timing["decode_attention (llama2 draft)"],
                      split["decode_attention.draft"], None),
                entry("flash_attention (llama2)", "flash_wgmma_kernel",
                      llama_timing["flash_attention (llama2)"],
                      paper_launches["flash_attention"], None)]
    report["kernels"] = kernels
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
