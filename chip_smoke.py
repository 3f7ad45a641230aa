"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure:
  1. print the card (nvidia-smi name and power limit) and versions; build the
     CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
     all at once); show from the SASS that the bf16 attention kernels (K1,
     K2, K3) run both products, the bf16 SSD-scan kernel (K4) its four and
     K2's two bf16 backward passes theirs on HGMMA (wgmma), and from ptxas
     that the backward passes spill nothing (K2's at head_dim 64 and 128);
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
     K4 launch on the CUDA-core kernel); serve mamba2-2.7b at full width (32
     of its 64 layers, d_model 2560), counting SSD-scan launches (every one on the
     tensor-core kernel), and profile a burst, splitting device time between
     prefill and decode;
  9. the dense M9 models: hold K1, K2 and K3 at G = 5 (qwen2.5-14b), 9
     (starcoder2-7b) and, at head_dim 120, 4 (h2o-danube-3-4b) against their
     plain versions (h2o's wrapped 4128-slot ring and 6000-token prompt under
     window 4096), time each serve's shapes, and time the reference's padded
     query heads against the port's at a decode step; check 2 full-width
     layers of each on the card against the CPU (fp32, nonzero QKV biases);
     serve qwen2.5-14b (24 of its 48 layers) on the dense path (eager and
     graphed, a profiled burst), starcoder2-7b paged (K3 at G = 9, prefix
     hits) and h2o-danube-3-4b (12 of its 24 layers) at max_len 8192 (long prompts wrap the ring, the window
     binds; a profiled burst);
 10. the MoE models: hold K1, K2 and K3 at G = 8 (qwen3-moe-30b-a3b) and,
     at D = 128 on mixtral-8x7b's wrapped 4128-slot ring under its window,
     4 against their plain versions and time each serve's shapes (K3 at G =
     8 too); check 2 full-width qwen3-moe layers and 1 mixtral layer on the card
     against the CPU (fp32: each token's chosen experts and its keep mask
     at capacity identical, then the logits); with marker kernels and drop
     counters in the MoE layer, serve qwen3-moe-30b-a3b at full width (8
     of 48 layers, 128 experts top-8) on the dense serve's path, graphed, with
     the share of assignments dropped at capacity and a profiled burst
     split into expert products, dispatch and combine, the other GEMMs, K1,
     K2 and the rest; a short sampled serve eager and graphed, token for
     token; and mixtral-8x7b at full width and 4 of its 32 layers at
     max_len 8192 (8 prompts of 4500-6000 tokens wrap the ring), graphed,
     with the same numbers and a profiled burst;
 11. the encoder-decoder and the vision-prefix model: hold K1 not causal
     (cross attention, bf16 and fp32) at seamless-m4t-large-v2's heads (H =
     K = 16, D = 64) over 1,024 memory slots for T = 1, 5 and 300, rows that
     see 1,024 down to 0 slots, the slots past each row's memory poisoned;
     K2 not causal (the encoder) at 1,024 and 100 frames; K1-K3 at
     internvl2-1b's G = 7 (``head_checks``); time each call of both models'
     runs; check each model at full width and 2 layers (seamless also 2
     encoder layers) on the card against the CPU (fp32); run each at full
     width and depth in bf16 through ``build_model`` (4 rows of 1,024 stub
     frames and 64-token prompts, or of 256 stub patches and 256-token
     prompts; a prefill and 32 greedy tokens), counting K1 and K2 calls by
     mask per prefill and per step, with a rollback check; and check that
     K1 under autograd raises on the card and launches nothing (training's
     cross attention runs K2: phase 14);
 12. jamba-1.5-large-398b, the hybrid (Mamba2 and attention layers, MoE
     16 experts top-2 on every second), at full width over runs of its
     first block that fit the card: K1, K2 and K2's backward at H = 64,
     K = 8, D = 128 and K4's forward and backward at 256 heads against their
     plain versions in both dtypes, bit for bit on repeat, timed; layers 6-7
     (Mamba2 + MLP, attention + MoE) in fp32 on the card against the CPU
     (routing and keep masks identical, then the logits and the state);
     layers 4-7 served on 2 pairs x 8 slots (12 requests, 32 new tokens,
     the n-gram draft), eager and then graphed, equal, with MoE drops and a
     profiled burst split by kernel group; its training run is phase 14's;
 13. the serving front door at full width on the dense serve's weights:
     ``StreamServe`` behind ``GatewayThread`` (trace on, warmed up): an
     idle-gateway request against the same prompt served in process, a wave
     of 24 concurrent SSE streams (client TTFT/TPOT, ms per engine step), a
     wave of 40 with 429s, a dropped stream and ``/admin/fail_worker/1``;
     no graph captured during HTTP serving; then the dense graphed serve
     with StreamTrace off and on (equal tokens and launches, bookkeeping ms
     a step each); then ``python -m repro_torch.launch.serve --no-reduced
     --warmup`` with a cancel, a worker failure and a Chrome trace;
 14. training, qwen3-1.7b: hold K2's backward (``flash_attention_bwd.cu``)
     against the plain version's autograd (dq, dk, dv; bf16 and fp32 at the
     training shape B=4 S=2048 H=16 K=8 D=128, a ragged S = 1000, G = 1 at
     H = K = 32, a window of 512, head_dim 64, and S = 1000 under a window of
     130 at G = 4 and head_dim 64; bf16 on the tensor-core passes
     ``dkdv_wgmma_kernel`` and ``dq_wgmma_kernel``, fp32 on the CUDA cores)
     and K2's log-sum-exp against the plain scores' (serving's K2, without
     it, gives the same bits); each gradient row against the backward's
     plain arithmetic within 0.1 of its RMS (bf16), with a control that
     drops one query tile; two backward calls at the training shape bit
     for bit; time the backward, the plain version's backward and SDPA's
     backward, and K2's
     forward with lse; check 2 full-width fp32 layers' loss and every
     gradient on the card against the CPU (the fp32 backward on the CUDA
     cores); run ``launch.train`` at full width
     and depth, bf16 (8 steps of 4 x 2048 tokens, remat "minimal", its two
     checkpoints: 28 K2 backward launches a step, all on the tensor-core
     passes, the forward's counted, ms a
     step, MFU, peak memory, a profiled step split by kernel group); and a
     2-layer full-width run with ``--fail-at 6`` whose final loss equals the
     uninterrupted run's, bit for bit;
     Mamba2 and MoE training: K2's backward also at qwen3-moe's G = 8 (B=4
     S=2048 H=32 K=4, both dtypes, timed against SDPA's backward), K4's
     forward at the training shape (B=4 S=2048) among the SSD checks and
     timed there; K4's backward (``ssd_scan_bwd.cu``) against the plain
     scan's autograd (every gradient: fp32 within 1e-4 of the plain version
     run in float64, bf16 within 2e-2 and each row within 0.1 of its RMS,
     with a control that drops a chunk), bit for bit on repeat, timed;
     2 fp32 full-width layers of mamba2-2.7b and qwen3-moe-30b-a3b (routing
     and keep masks identical) against the CPU; ``launch.train`` on
     mamba2-2.7b at full width and 32 of its 64 layers and
     qwen3-moe-30b-a3b at full width and 4 of its 48 layers (8 bf16 steps of 4 x 2048 tokens each,
     no saves: K4 forward and backward or K2 forward and backward launches
     a step, the router's losses, ms a step, MFU, peak memory, a profiled
     step split into GEMMs, expert products, K4, K2 and the rest);
     encoder-decoder and vision-prefix training: K2's forward and backward
     over queries and keys of their own lengths without a mask
     (seamless-m4t-large-v2's cross attention over 16 and 1,024 frames, a
     ragged 1000 x 300, its encoder over 1,024 and 16 frames), its
     decoder's self-attention at head_dim 64 and internvl2-1b's causal 256 +
     2,048 positions at G = 7, both dtypes, rows within 0.1 of their RMS, a
     drop-a-tile control, bit for bit on repeat, timed against SDPA's
     backward; 2 fp32 full-width layers of each (seamless also 2 encoder
     layers) on random frames or patches against the CPU; ``launch.train``
     on each at full width and depth (8 bf16 steps of 4 x 2048 tokens behind
     the CLI's 16 frames or 256 patches a row, seeded random in place of
     its zeros, which overflow the gradient at depth, no saves: K2's
     launches by shape, 72 or 24 backward launches a step, MFU, peak, a
     profiled step); jamba's layers 6-7 through ``launch.train`` under its
     own adafloor and remat "full" (8 bf16 steps of 4 x 2048 tokens, no
     saves: K2 and K4 forward and backward launches a step, MFU, peak
     memory, a profiled step);
 15. the examples (examples/*_torch.py, the reference's four): K1, K2 and
     K4 at their reduced shapes against the plain versions (K2's training
     call at head_dim 32 and K4's at P = 32, N = 16 under autograd, K2's
     backward and K4 on zero-padded copies), timed; the quickstart (80 training steps of the
     reduced qwen3-1.7b, then its weights served: the loss falls, every
     handle streams and finishes; each part's launches and seconds) and
     serve_cluster (8 requests, pair 1 failed, all complete; its simulator
     on the host) before the training group; after it, train_resilient
     (the reduced mamba2-2.7b: a restart and a compressed restart bit for
     bit, compression within 0.1) and ``launch.train --compress-grads`` on
     mamba2-2.7b at full width and 32 layers beside the uncompressed run
     (K4 launches a step equal, the loss gap, ms a step, peak), then
     ``compress_decompress`` alone over one step's gradients against its
     byte bound;
 16. M11, distributed, after the quickstart and serve_cluster (no kernel
     of its own: the context-parallel partials and the expert products are
     plain PyTorch, as in the reference): (a) one rank over NCCL on a (1, 1)
     data x model mesh, the full-width qwen3-moe-30b-a3b MoE layer (bf16,
     seeded) on 8 x 5 verify tokens and a 4 x 512 prefill through
     ``apply_moe`` under ``use_mesh`` (the expert-parallel path, counted;
     no K1-K4 launch) against the layer without a mesh, bf16 2e-2 and
     whether the bits are equal, each timed with the all-reduce alone; (b)
     two ranks on the one card over gloo on a (1, 2) mesh (this script run
     as ``--distributed-rank``): qwen3-1.7b's attention decode at full width
     under context parallelism (256 of 512 slots a rank, a verify crossing
     the ranks' boundary) against K1 on the whole cache, bf16 and fp32 at
     TOL, the written slots equal, ``attention_decode`` under the mesh
     against the layer without one, and the MoE layer with 64 experts a
     rank against one rank, each timed beside K1 or the one-rank layer with
     its all-reduces alone;
 17. M12, the dry run (after the distributed group): (a) full-width
     qwen3-1.7b (28 layers, bf16) counted by ``launch.dryrun_lib`` on meta
     and then run on the card under the same analyzer at a 4 x 2048 prefill
     and an 8 x 5 verify over 512 slots: FLOPs, bytes and kernel calls equal,
     argument bytes those of the real tensors; the predicted peak against
     ``max_memory_allocated`` and the compute/memory roofline term against
     the step's device ms, printed; K1, K2 and K4 at a rank's heads under a
     2-way model axis checked and timed; (b), in phase 16's two gloo ranks:
     one full-width qwen3-1.7b layer and one mamba2-2.7b layer (with their
     vocab-parallel embedding and head) tensor parallel at model = 2 against
     the layer without a mesh (fp32 1e-5; bf16 ``bf16_error``: against the
     same layer in fp32, within 1.25x the no-mesh layer's largest and mean
     error), in prefill and a verify, timed with their all-reduces; in phase 16 (a), the same layers
     on one NCCL rank bit-equal to the layer without a mesh;
     resilient training under a mesh, in phase 16 (b)'s two ranks after
     its training steps: (i) a compressed AdamW step of full-width
     qwen3-1.7b at 2 layers (S = 2048) under ZeRO-1 at data = 2 and at
     model = 2, and (iv) of one mamba2-2.7b layer at model = 2, each against
     the compressed step without a mesh (fp32 with the CPU test's limits of
     compressed steps; bf16 the gradients and the dequantised gradients by
     their mean and largest errors against the fp32 step),
     K2's or K4's forward and backward counted; (ii) two compressed steps at
     data = 2, a checkpoint of whole arrays, restored at model = 2 and
     without a mesh (on each rank, and in this process without a process
     group), each continued two steps and held to the run without a mesh;
     (iii) its restore at data = 2, bit-equal to the uninterrupted run;
     save and restore seconds, the checkpoint's bytes, ms a step;
 18. print the kernel table as one JSON line, then the result line.
Every serve of phases 4-8, and phase 9's qwen2.5-14b serve, runs twice on
the same weights (phase 9 profiles only graphed serves and runs its other
serves graphed only): eager (its lanes'
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
import functools
import json
import os
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
               "decode": 0.4635, "ssd_scan": 0.2542, "ssd_scan_bwd": 9.4305}
REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention.py:113",
    "flash_attention": "src/repro/kernels/flash_attention.py:131",
    # what JAX differentiates in training: the same TPU kernel's gradient
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:131",
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:257",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:122",
    # what JAX differentiates in training: the plain scan of the same TPU kernel
    "ssd_scan_bwd": "src/repro/kernels/ssd_scan.py:122",
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


def same_bits(tag: str, call) -> None:
    """Fail unless two calls on the same inputs give the same bits."""
    import torch
    from torch.utils._pytree import tree_flatten

    runs = [tree_flatten(call())[0] for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*runs, strict=True)):
        fail(f"{tag}: two calls on the same inputs gave different bits")
    print(f"{tag}: two calls give the same bits")


# ------------------------------------------------------------------ kernels

def tensor_core_sass(report: dict) -> None:
    """The bf16 kernels' products as compiled: the HGMMA (wgmma) instruction
    forms in the SASS of decode_wgmma_kernel, flash_wgmma_kernel and
    paged_wgmma_kernel at head_dim 128, and of ssd_wgmma_kernel (``cuobjdump
    -sass`` of the built libraries), the attention kernels also at head_dim
    120 (a 128-wide tile, its last 8 columns zeros), K2's backward passes
    dkdv_wgmma_kernel and dq_wgmma_kernel at head_dim 128, and K4's backward
    ssd_bwd_wgmma_kernel.  Fails unless each attention kernel holds
    S = QK^T (64x64x16) and O += PV (64x128x16) on the tensor cores, the
    SSD scan its scores, intra- and inter-chunk terms (64x64x16) and state
    update (64x128x16), each backward pass its recomputed S and dP
    (64x64x16) and its gradient products (64x128x16), and K4's backward its
    scores and dx's products (64x64x16) and its state, dB and dC products
    (64x128x16)."""
    import re

    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    found, sass = {}, {}
    for lib, kernel, D in (("decode_attention", "decode_wgmma_kernel", 128),
                           ("flash_attention", "flash_wgmma_kernel", 128),
                           ("decode_attention_paged", "paged_wgmma_kernel", 128),
                           ("decode_attention", "decode_wgmma_kernel", 120),
                           ("flash_attention", "flash_wgmma_kernel", 120),
                           ("decode_attention_paged", "paged_wgmma_kernel", 120),
                           ("ssd_scan", "ssd_wgmma_kernel", None),
                           ("flash_attention_bwd", "dkdv_wgmma_kernel", 128),
                           ("flash_attention_bwd", "dq_wgmma_kernel", 128),
                           ("ssd_scan_bwd", "ssd_bwd_wgmma_kernel", None)):
        if lib not in sass:
            sass[lib] = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(lib))],
                                       capture_output=True, text=True, timeout=120).stdout
        tag, fn, forms = f"ILi{D}E" if D else "", "", set()
        for line in sass[lib].splitlines():
            if "Function :" in line:
                fn = line
            elif "HGMMA" in line and kernel in fn and tag in fn:
                forms.add(re.search(r"HGMMA\.(\S+)", line).group(1))
        name = kernel + (f" (head_dim {D})" if D else "")
        found[name] = sorted(forms)
        print(f"{name} SASS: HGMMA {', '.join(found[name]) or 'none'}")
        if not all(any(f.startswith(shape) for f in forms) for shape in ("64x64x16.F32.BF16",
                                                                          "64x128x16.F32.BF16")):
            fail(f"{name}: the SASS does not run its products on HGMMA")
    report["hgmma"] = found


def no_spills(report: dict, logs: dict) -> None:
    """The backward kernels on the tensor cores as ptxas compiled them (K2's
    passes at head_dim 64 and 128, K4's ssd_bwd_wgmma_kernel): their
    registers and spill bytes from the build's ``-Xptxas -v`` log.  Fails on
    any spill (a library built by an earlier run has no log: skipped)."""
    import re

    found, k2 = {}, ("dkdv_wgmma_kernel", "dq_wgmma_kernel")
    for lib, tag, names in (("flash_attention_bwd", "ILi64E", k2),
                            ("flash_attention_bwd", "ILi128E", k2),
                            ("ssd_scan_bwd", "", ("ssd_bwd_wgmma_kernel",))):
        if lib not in logs:
            print(f"{lib} was built before this run: no ptxas log to read")
            continue
        fn = ""
        for line in logs[lib].splitlines():
            if "Compiling entry function" in line:
                fn = next((k + tag for k in names if k + tag in line), "")
            elif fn and "spill stores" in line:
                found[fn] = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            elif fn and "Used" in line and "registers" in line:
                found[fn].append(int(re.search(r"Used (\d+) registers", line).group(1)))
        for name in names:
            label = name + (f" (head_dim {tag[3:-1]})" if tag else "")
            if len(found.get(name + tag, ())) != 3:
                fail(f"{label}: not in the ptxas log")
            stores, loads, regs = found[name + tag]
            print(f"{label}: {regs} registers, spill stores {stores} B, loads {loads} B")
            if stores or loads:
                fail(f"{label} spills registers")
    report["bwd_ptxas"] = found


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


def decode_cost(q, k, clen, pos, window=None, causal=True):
    """(bytes, ops) the function needs for these inputs: q, out, kv_pos and
    cache_len once, plus K and V of every slot some query row can see (inside
    its window, with one; every valid slot, not causal)."""
    import torch

    B, T, H, D = q.shape
    K = k.shape[2]
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + pos.numel() * 4 + clen.numel() * 4
    q_pos = clen[:, None].long() - T + torch.arange(T, device=pos.device)[None]  # (B, T)
    p = pos[:, None, :].long()
    vis = (p >= 0) & ((p <= q_pos[:, :, None]) | (not causal))
    if window is not None:
        vis &= p > q_pos[:, :, None] - window
    nbytes += int(vis.any(1).sum()) * 2 * K * D * esz
    return nbytes, int(vis.sum()) * H * 4 * D


def flash_cost(q, k, causal=True, q_offset=0, window=None):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    esz = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * esz
    pairs = (sum(min(Sk, q_offset + i + 1) - (0 if window is None else
                                              max(0, q_offset + i + 1 - window))
                 for i in range(Sq)) if causal else Sq * Sk)
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


def sdpa_decode(q, k, v, clen, pos, window=None, causal=True):
    """The library yardstick for decode on the same inputs (layout changes
    and the mask are made before timing; not causal, a key-length mask)."""
    import torch

    T = q.shape[1]
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    q_pos = clen[:, None].long() - T + torch.arange(T, device=q.device)[None]
    mask = (pos[:, None, :] >= 0) & ((pos[:, None, :].long() <= q_pos[:, :, None]) | (not causal))
    if window is not None:
        mask &= pos[:, None, :].long() > q_pos[:, :, None] - window
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


def decode_timing(g, B: int, T: int, S: int, H: int, K: int, D: int, window=None,
                  causal=True) -> dict:
    """K1 (bf16) on a full cache at (B, T, S, H, K, D), on copies rotated past
    the L2: checked against its plain version, then kernel, plain version and
    SDPA timed, and the bound of this input.  Not ``causal``: cross
    attention over S memory slots, all valid."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda

    sets = copies(lambda: decode_case(g, B, T, S, H, K, D, "bfloat16", [S - T] * B,
                                      poison=False), 2 * B * S * K * D * 2)
    q, k, v, clen, pos = sets[0]
    nbytes, ops = decode_cost(q, k, clen, pos, window, causal)
    kw = {"window": window, "causal": causal}
    e = check(f"decode timing set B={B} T={T} H={H} K={K} D={D} causal={causal}",
              decode_attention_cuda(q, k, v, clen, kv_positions=pos, **kw),
              ref.decode_attention(q, k, v, clen, kv_positions=pos, **kw), "bfloat16")
    lib = [sdpa_decode(*s, **kw) for s in sets]
    return {
        "shape": f"B={B} T={T} S={S} H={H} K={K} D={D} bf16"
                 + ("" if window is None else f" window={window}")
                 + ("" if causal else " not causal"),
        "ms": timed(lambda i: decode_attention_cuda(*sets[i % len(sets)][:4],
                                                    kv_positions=sets[i % len(sets)][4],
                                                    **kw), 200),
        "plain_ms": timed(lambda i: ref.decode_attention(
            *sets[i % len(sets)][:4], kv_positions=sets[i % len(sets)][4], **kw), 20),
        "library_ms": timed(lambda i: lib[i % len(lib)](), 50),
        "bound": bound_ms(nbytes, ops, "bfloat16"), "err": e,
    }


def flash_timing(g, B: int, Sq: int, H: int, K: int, D: int, window=None,
                 causal=True) -> dict:
    """K2 (bf16, causal with an optional window, or not causal) at (B, Sq, H,
    K, D) on copies rotated past the L2: checked against its plain version,
    then kernel, plain version and SDPA timed (with a window, SDPA takes the
    mask, made before timing), and the bound."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    fsets = copies(lambda: tuple(torch.randn(B, Sq, h, D, generator=g, device="cuda")
                                 .to(torch.bfloat16) for h in (H, K, K)),
                   2 * B * Sq * (H + 2 * K) * D)
    nbytes, ops = flash_cost(fsets[0][0], fsets[0][1], causal, window=window)
    fkw = {"window": window, "causal": causal}
    e = check(f"flash timing set B={B} S={Sq} H={H} K={K} D={D} {fkw}",
              flash_attention_cuda(*fsets[0], **fkw), ref.flash_attention(*fsets[0], **fkw),
              "bfloat16")
    tsets = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in fsets]
    kw = {"is_causal": causal}
    if window is not None:
        i = torch.arange(Sq, device="cuda")
        kw = {"attn_mask": (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)}
    return {
        "shape": f"B={B} Sq=Sk={Sq} H={H} K={K} D={D} {'causal' if causal else 'not causal'} "
                 "bf16" + ("" if window is None else f" window={window}"),
        "ms": timed(lambda i: flash_attention_cuda(*fsets[i % len(fsets)], **fkw), 50),
        "plain_ms": timed(lambda i: ref.flash_attention(*fsets[i % len(fsets)], **fkw), 10),
        "library_ms": timed(lambda i: sdpa(*tsets[i % len(tsets)], **kw), 50),
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

    out = paged_timing(g, lines, err)
    report["paged_kernel_checks"] = lines
    return out


def paged_timing(g, lines: list, err: list, H=16, K=8, D=128, tag="") -> dict:
    """K3 (bf16) at the paged serve's largest decode shape (B=8, T=9 over 1024
    positions a row) and admission shape (T=1024), on 8 disjoint page sets
    rotated past the L2: each checked against its plain version (its error
    added to ``err``: [decode, admission]), then kernel, plain version and a
    gather plus SDPA timed, and the bound."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_paged_cuda as k3

    out = {}
    pools = tuple(torch.randn(4096, 16, K, D, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
    perm = torch.randperm(4096, generator=g, device="cuda").tolist()
    for key, T, iters in (("decode", 9, (200, 20, 50)), ("admission", 1024, (20, 3, 10))):
        # 8 disjoint page sets of 8 x 64 pages: every call reads 8 x 1024
        # positions of the pool that the last call did not, past the 50 MB L2
        sets = [paged_case(g, 8, T, "bfloat16", [1024] * 8, H=H, K=K, D=D,
                           perm=perm[i * 512:(i + 1) * 512], pools=pools) for i in range(8)]
        nbytes, ops = paged_cost(sets[0][0], sets[0][1], sets[0][4], sets[0][3])
        # the timed shape is the path's own (admission runs K3 at T=1024): check it too
        e = check(f"paged {tag}{key} T={T} bfloat16", k3(*sets[0]),
                  ref.decode_attention_paged(*sets[0]), "bfloat16")
        err[key == "admission"] = max(err[key == "admission"], e)
        lines.append(f"decode_attention_paged {tag}B=8 T={T} H={H} K={K} D={D} bfloat16 "
                     f"({key} timing set): max_abs_err={e:.3g}")
        print(lines[-1])
        lib = [gather_sdpa(*s) for s in sets]
        out[key] = {
            "shape": f"B=8 T={T} positions=1024 ps=16 H={H} K={K} D={D} bf16",
            "ms": timed(lambda i: k3(*sets[i % 8]), iters[0]),
            "plain_ms": timed(lambda i: ref.decode_attention_paged(*sets[i % 8]), iters[1]),
            "library_ms": timed(lambda i: lib[i % 8](), iters[2]),
            "bound": bound_ms(nbytes, ops, "bfloat16"),
        }
        r = out[key]
        was = f" (previous kernel {PREVIOUS_MS[key]} ms)" if key in PREVIOUS_MS and not tag else ""
        print(f"decode_attention_paged {tag}{key} [{r['shape']}]: kernel {r['ms']:.4f} ms{was}, "
              f"plain {r['plain_ms']:.4f} ms, gather+sdpa {r['library_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")
    for key, r in out.items():  # the largest bf16 error over the kernel's own checks
        r["max_abs_err"] = err[key == "admission"]
    return out


# -------------------------------------------------------------------- model

def model_phase(report: dict, arch: str = "qwen3-1.7b", n_layers: int = 2) -> None:
    """The full-width model's first 2 layers on the card (CUDA kernels) against
    the same weights on the CPU (plain versions), float32: prefill of a
    bucketed batch, a 5-token verify step, a rewind and a plain step.  Every
    float32 K1 and K3 launch must take the CUDA-core kernel (decode_kernel,
    paged_decode_kernel), none the bf16 tensor-core one.  qwen3-1.7b (two
    query heads a KV head), llama2-7b (one: MHA, an untied head) and the M9
    models: qwen2.5-14b (five, QKV biases), starcoder2-7b (nine, GELU) and
    h2o-danube-3-4b (four, head_dim 120, window 4096), and the MoE models,
    qwen3-moe-30b-a3b (eight, 128 experts top-8) and mixtral-8x7b (four, 8
    experts top-2, window 4096, ``n_layers`` 1), whose routing is compared
    first (``same_routing``).  QKV biases are set to nonzero values (the
    seeded init leaves them zero)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32")
    gpu = build_model(cfg, "cuda")
    params = gpu.init(1)
    for layer in params["layers"]:
        for name in ("bq", "bk", "bv"):
            if name in layer["attn"]:
                layer["attn"][name].normal_(0.0, 0.5)
    cpu_params = to_cpu(params)
    cpu = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, dtype=torch.int32)
    lengths = torch.tensor([64, 37], dtype=torch.int32)
    errs = []
    zero_counts()
    routes = contextlib.ExitStack()
    seen = routes.enter_context(routing_recorded()) if cfg.moe else None
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
    routes.close()
    launches = read_counts()
    tag = f"{arch} model check"
    if seen is not None:
        same_routing(tag, cfg, seen, report)
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
        if result["captured_after_warmup"]:  # every serve held here is bucketed
            fail(f"{tag}: {result['captured_after_warmup']} graphs captured after warmup")
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
    if bucketed and g.get("programs_after_warmup") and not key.startswith(("mamba", "jamba")):
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
            "flash_attention_bwd": fa.flash_attention_bwd_cuda,
            "decode_attention_paged": da.decode_attention_paged_cuda,
            "ssd_scan": ssd.ssd_scan_cuda,
            "ssd_scan_bwd": ssd.ssd_scan_bwd_cuda}


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = fn.wgmma_launches = 0
    for t in MOE_PROBE.values():
        t.zero_()


def read_counts() -> dict:
    """Launches per kernel, and per bf16 tensor-core path ("<name>.wgmma");
    while moe_probes() is on, the MoE assignments made and dropped too."""
    counts = {name: fn.launches for name, fn in kernel_counters().items()}
    counts.update({f"{name}.wgmma": fn.wgmma_launches for name, fn in kernel_counters().items()})
    counts.update({f"moe_{name}": int(t) for name, t in MOE_PROBE.items()})
    return counts


SERVE_LENS = (16, 400, 24, 300, 40, 200, 64, 130, 350, 33, 100, 250)


def serve_phase(report: dict, params=None, graphed=True, temperature=0.0, trace=None,
                arch="qwen3-1.7b", new_tokens=32, lens=SERVE_LENS, n_layers=None):
    """The default serve at full width (sampled, with ``temperature`` > 0;
    with ``trace``, StreamTrace set so and the report keyed by it; another
    ``arch`` on the same path keys the report by its name; ``n_layers`` cuts
    its depth): the first 8 of ``lens`` at tick 0, the rest 3 steps later,
    ``new_tokens`` each."""
    import numpy as np
    import torch

    from repro_torch.api import ServeConfig

    cfg = ServeConfig(arch=arch, reduced=False, n_layers=n_layers, n_pairs=2, max_batch=8,
                      max_len=512, max_new_tokens=new_tokens, temperature=temperature,
                      trace=trace or "off")
    t0 = time.perf_counter()
    serve = served(cfg, graphed, **({} if params is None else {"params": params}))
    torch.cuda.synchronize()
    arch = serve.arch
    print(f"serve: {arch.name} L={arch.n_layers} d_model={arch.d_model} vocab={arch.vocab_size} "
          f"{arch.dtype}, {cfg.n_pairs} pairs x {cfg.max_batch} slots, max_len {cfg.max_len}; "
          f"init {time.perf_counter() - t0:.2f} s")
    bad = instrument(serve)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab_size, n).tolist() for n in lens]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = drive(serve, {0: prompts[:8], 3: prompts[8:]})  # a second wave joins mid-decode
    launches = read_counts()
    tag = ("sampled serve" if temperature else "serve") + (f" trace {trace}" if trace else "")
    tag = tag if cfg.arch == "qwen3-1.7b" else f"{cfg.arch} {tag}"
    result = serve_stats(tag + ("" if graphed else " (eager)"), serve, bad, run, launches)
    L, calls = arch.n_layers, result
    if launches["flash_attention"] != L * calls["prefill_calls"] or not calls["prefill_calls"]:
        fail(f"serve: flash launches {launches['flash_attention']} != {L} x "
             f"{calls['prefill_calls']} prefill calls")
    if launches["decode_attention"] != L * calls["decode_calls"] or not calls["decode_calls"]:
        fail(f"serve: decode launches {launches['decode_attention']} != {L} x "
             f"{calls['decode_calls']} decode calls")
    wgmma_only(launches, "serve", "flash_attention", "decode_attention")
    result["prompt_lens"] = list(lens)
    report[tag.replace(" ", "_") + ("" if graphed else "_eager")] = result
    return launches, serve


def paged_serve_phase(params, report: dict, graphed=True, arch="qwen3-1.7b"):
    """The paged path at full width: 16 requests of 32 new tokens on 2 pairs
    (max_len 512, max_context 1024, 4096 pages of 16 a pair).  8 share a
    256-token prefix and arrive once the first of them was admitted, so the
    rest hit the radix index; 4 prompts of 600-900 tokens exceed max_len; 4
    are short and unique.  Every admission and decode step runs K3.  Another
    ``arch`` (seeded weights with ``params`` None) keys the report by its name."""
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.api import ServeConfig

    cfg = ServeConfig(arch=arch, reduced=False, n_pairs=2, max_batch=8, max_len=512,
                      max_new_tokens=32, paged_kv=True, kv_block_size=16, max_context=1024)
    serve = served(cfg, graphed, **({} if params is None else {"params": params}))
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
    tag = "paged serve" if cfg.arch == "qwen3-1.7b" else f"{cfg.arch} paged serve"
    result = serve_stats(tag + ("" if graphed else " (eager)"), serve, bad, run, launches)
    handles = run[0]
    hits = [h.request.cache_hit_tokens for h in handles]
    routing = Counter(h.request.worker_id for h in handles if list(h.request.prompt[:256]) == prefix)
    k3_calls = result["prefill_calls"] + result["decode_calls"]
    print(f"{tag}: cache_hit_tokens {sum(hits)} (per request {hits}); shared-prefix "
          f"requests per pair {dict(sorted(routing.items()))}; K3 launches "
          f"{launches['decode_attention_paged']} = {arch.n_layers} x {k3_calls} calls")
    if sum(hits) <= 0:
        fail(f"{tag}: no request hit the radix index")
    if launches["decode_attention_paged"] != arch.n_layers * k3_calls or not k3_calls:
        fail(f"{tag}: K3 launches {launches['decode_attention_paged']} != "
             f"{arch.n_layers} x {k3_calls} admission and decode calls")
    print(f"{tag}: K3 launches on paged_wgmma_kernel "
          f"{launches['decode_attention_paged.wgmma']} of {launches['decode_attention_paged']}")
    wgmma_only(launches, tag, "decode_attention_paged")
    if not any(len(h.request.prompt) > cfg.max_len for h in handles):
        fail(f"{tag}: no prompt beyond max_len was served")
    result.update(cache_hit_tokens=hits, shared_prefix_routing=dict(routing),
                  prompt_lens=[len(h.request.prompt) for h in handles])
    report[tag.replace(" ", "_") + ("" if graphed else "_eager")] = result
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
    device time against the burst's is prefill's share, the rest decode's.
    Durations come from the profiler's raw records (``kineto_results``), as
    moe_profile and the training phase read them: building the profiler's
    event tree took longer than the bursts themselves."""
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

    def device_ms(prof):  # (name, ms) of each kernel and copy, from the raw records
        return [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]

    wall = burst(seed)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_profiled = burst(seed + paged)  # a paged repeat would hit the first's pages
    by_name: Counter = Counter()
    for name, ms in device_ms(prof):
        by_name[name] += ms
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
        prefill_ms = sum(ms for _, ms in device_ms(alone))
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
PAPER_NEW_TOKENS = 32  # the paper preset's 512 new tokens cut to fit the time limit


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


# ------------------------------------------ the dense M9 models (ROADMAP §1 item 3)

# each M9 model's attention heads (H, K, D): G = 5, 9 and 4 query heads a KV
# head; h2o-danube's head_dim 120 runs on a 128-wide tile
M9_HEADS = {"qwen2.5-14b": (40, 8, 128), "starcoder2-7b": (36, 4, 128),
            "h2o-danube-3-4b": (32, 8, 120)}
H2O_LEN, H2O_CAP, H2O_WINDOW = 8192, 4128, 4096  # max_len, its ring (window + 32), window
RING_ARCHS = ("h2o-danube-3-4b", "mixtral-8x7b")  # window 4096: served on a 4128-slot ring
# the h2o serve's prompts: four past the window and the ring, four short
H2O_LENS = (4500, 16, 5200, 40, 6000, 130, 4800, 300)


def head_checks(g, heads: dict, err: dict, lines: list) -> None:
    """K1, K2 and K3 at each model's heads (H, K, D), held against their plain
    versions: K1 at the dense serve's cache (B=8, S=512), or for a model
    with a window of 4096 on a ring of 4128 slots (rows wrapped and not), for
    T = 1, 5, 9 and a chunk of 64 in bf16 and T = 5 in fp32; K2 at the 512
    bucket, a ragged 100 and fp32, and under a window a 6000-token prompt (S
    > 4096, ragged), a continuation and fp32 with a window; K3 over shuffled
    pages at T = 1, 9 (and with a window) and an admission of 128, bf16, and
    T = 9 fp32.  Every bf16 call must take the tensor-core kernel, every
    fp32 call the CUDA-core one.  ``err`` gathers each kernel's largest bf16
    error, ``lines`` the printed lines."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda as k1
    from repro_torch.kernels.decode_attention import decode_attention_paged_cuda as k3
    from repro_torch.kernels.flash_attention import flash_attention_cuda as k2

    def held(tag, name, fn, args, kw, want, dt):
        before = fn.wgmma_launches
        got = fn(*args, **kw)
        if fn.wgmma_launches - before != int(dt == "bfloat16"):
            fail(f"{tag}: took the wrong kernel")
        e = check(tag, got, want(), dt)
        if dt == "bfloat16":
            err[name] = max(err.get(name, 0.0), e)
        lines.append(f"{tag}: max_abs_err={e:.3g}")
        print(lines[-1])

    for arch, (H, K, D) in heads.items():
        ring = arch in RING_ARCHS
        S, window = (H2O_CAP, H2O_WINDOW) if ring else (512, None)
        fills = ([6000, 4200, 100, 4127, 8000, 3000, 4096, 0] if ring
                 else [20, 60, 140, 200, 290, 350, 420, 490])
        for T, dt in ((1, "bfloat16"), (5, "bfloat16"), (9, "bfloat16"), (64, "bfloat16"),
                      (5, "float32")):
            q, k, v, clen, pos = decode_case(g, 8, T, S, H, K, D, dt, fills, ring=ring)
            held(f"{arch} decode_attention B=8 T={T} S={S} H={H} K={K} D={D} {dt} "
                 f"window={window}", "decode_attention", k1, (q, k, v, clen),
                 {"kv_positions": pos, "window": window},
                 lambda: ref.decode_attention(q, k, v, clen, kv_positions=pos, window=window), dt)
        flash = [(2, 512, "bfloat16", {}), (2, 100, "bfloat16", {}), (1, 256, "float32", {})]
        if ring:
            flash += [(1, 6000, "bfloat16", {"window": H2O_WINDOW}),
                      (1, 64, "bfloat16", {"q_offset": 4500, "window": H2O_WINDOW}),
                      (1, 300, "float32", {"window": 100})]
        for B, Sq, dt, kw in flash:
            Sk, dtype = Sq + kw.get("q_offset", 0), getattr(torch, dt)
            q = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
            k, v = (torch.randn(B, Sk, K, D, generator=g, device="cuda").to(dtype)
                    for _ in range(2))
            held(f"{arch} flash_attention B={B} S={Sq} H={H} K={K} D={D} {dt} {kw}",
                 "flash_attention", k2, (q, k, v), kw,
                 lambda: ref.flash_attention(q, k, v, **kw), dt)
        for T, dt, win in ((1, "bfloat16", None), (9, "bfloat16", None), (9, "bfloat16", 100),
                           (128, "bfloat16", None), (9, "float32", None)):
            args = paged_case(g, 8, T, dt, [T + 37, 1024, T + 300, 700, T + 5, 513, T + 130, 0],
                              H=H, K=K, D=D)
            held(f"{arch} decode_attention_paged B=8 T={T} H={H} K={K} D={D} {dt} window={win}",
                 "decode_attention_paged", k3, args, {"window": win},
                 lambda: ref.decode_attention_paged(*args, window=win), dt)


def m9_kernel_phase(report: dict) -> dict:
    """K1, K2 and K3 at the M9 models' heads (``head_checks``): G = 5, 9 and,
    at D = 120 on h2o's ring under its window, 4.  Then each serve's shapes
    timed (kernel, plain version, SDPA, bound), and the reference's padded
    heads against the port's at a decode step."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(21)
    err, lines = {}, []
    head_checks(g, M9_HEADS, err, lines)

    # ---- timing at each serve's shapes: qwen2.5's verify step at the depth-4
    # bucket (B=8 T=5) and its 512 prefill bucket; h2o's verify on a full ring
    # (B=4, its max_batch) and its 8192 prefill bucket, under the window;
    # starcoder2's paged decode and admission
    H, K, D = M9_HEADS["qwen2.5-14b"]
    out = {"decode_attention (qwen2.5 verify)": decode_timing(g, 8, 5, 512, H, K, D),
           "flash_attention (qwen2.5)": flash_timing(g, 4, 512, H, K, D)}
    H, K, D = M9_HEADS["h2o-danube-3-4b"]
    out["decode_attention (h2o verify)"] = decode_timing(g, 4, 5, H2O_CAP, H, K, D,
                                                         window=H2O_WINDOW)
    out["flash_attention (h2o)"] = flash_timing(g, 1, H2O_LEN, H, K, D, window=H2O_WINDOW)
    for name, r in out.items():
        r["max_abs_err"] = max(err[name.split()[0]], r.pop("err"))
        show_timing(name, r)
    H, K, D = M9_HEADS["starcoder2-7b"]
    paged = paged_timing(g, lines, [err["decode_attention_paged"]] * 2, H, K, D, "starcoder2 ")
    out.update({f"decode_attention_paged (starcoder2 {key})": r for key, r in paged.items()})
    report["m9_kernel_checks"] = lines
    report["padded_heads"] = {arch: padded_timing(g, arch)
                              for arch in ("qwen2.5-14b", "starcoder2-7b")}
    return out


def padded_timing(g, arch: str) -> dict:
    """What the reference's query-head padding would cost on this card: the
    attention half of a decode step (q projection, K1, output projection) over
    every layer, each with its own weights, at B=8 T=5 against a full
    512-slot cache, with the port's H heads and with the reference's padded
    heads (K1 at the padded G, the pad heads masked to zero before wo).  Each
    variant is captured once as a CUDA graph (the host's launch rate would
    otherwise bound a step of ~200 small launches) and replayed in turns:
    unpadded, padded, padded, unpadded."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention_cuda as k1

    cfg = get_config(arch)
    H, Hp, K, D, d, L = (cfg.n_heads, cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.d_model, cfg.n_layers)
    B, T, S = 8, 5, 512
    _, k, v, clen, pos = decode_case(g, B, T, S, H, K, D, "bfloat16", [S - T] * B, poison=False)
    x = torch.randn(B * T, d, generator=g, device="cuda").to(torch.bfloat16)
    real = (torch.arange(Hp, device="cuda") % cfg.padded_group < H // K).to(torch.bfloat16)

    def weights(heads):
        return [tuple((torch.randn(*shape, generator=g, device="cuda") * 0.02).to(torch.bfloat16)
                      for shape in ((d, heads * D), (heads * D, d))) for _ in range(L)]

    def step(ws, heads):
        for wq, wo in ws:
            o = k1((x @ wq).view(B, T, heads, D), k, v, clen, kv_positions=pos)
            if heads != H:
                o = o * real[:, None]
            y = o.view(B * T, heads * D) @ wo
        return y

    side, graphs = torch.cuda.Stream(), {}
    for name, heads in (("unpadded", H), ("padded", Hp)):
        ws = weights(heads)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # cuBLAS makes its handle here, outside the capture
            step(ws, heads)
        torch.cuda.synchronize()
        graphs[name] = (torch.cuda.CUDAGraph(), ws)
        with torch.cuda.graph(graphs[name][0], stream=side):
            step(ws, heads)
    ms = {"unpadded": [], "padded": []}
    for name in ("unpadded", "padded", "padded", "unpadded"):
        ms[name].append(timed(lambda i: graphs[name][0].replay(), 20))
    r = {"shape": f"{L} layers, B={B} T={T} S={S} K={K} D={D} d_model={d} bf16",
         "heads": [H, Hp], "G": [H // K, Hp // K], "unpadded_ms": ms["unpadded"],
         "padded_ms": ms["padded"], "pad_weight_gb": 2 * (Hp - H) * D * d * L * 2 / 1e9}
    print(f"{arch} padded heads [{r['shape']}]: q projection + K1 + output projection over "
          f"every layer, {H} heads (G={H // K}) {sum(ms['unpadded']) / 2:.4f} ms against the "
          f"reference's {Hp} (G={Hp // K}) {sum(ms['padded']) / 2:.4f} ms (in turns: "
          f"{ms['unpadded']}, {ms['padded']}); pad wq/wo {r['pad_weight_gb']:.3f} GB")
    del graphs
    return r


def ring_serve_phase(report: dict, arch="h2o-danube-3-4b", key="h2o", lens=H2O_LENS,
                     max_batch=4, new_tokens=32, n_layers=None):
    """A model with a window of 4096 at full width with max_len 8192, 2 pairs:
    each slot's ring holds 4128 positions (the window and a 32-token
    speculative margin), so prompts of 4500-6000 tokens wrap it and the
    window binds on every step of theirs.  h2o-danube-3-4b (``n_layers``, 12 of
    24, d_model 3840, 32 heads over 8 KV heads of 120; 4 slots a pair, four long
    prompts and four short) and mixtral-8x7b (``n_layers`` 4 of 32, d_model
    4096, 8 experts top-2; 8 slots a pair, eight long prompts).  K2 on every
    prefill (the long ones at the 8192 bucket, under the window), K1 on every
    decode and verify, all on the tensor-core kernels; graphed."""
    import numpy as np
    import torch

    from repro_torch.api import ServeConfig

    cfg = ServeConfig(arch=arch, reduced=False, n_layers=n_layers, n_pairs=2,
                      max_batch=max_batch, max_len=H2O_LEN, max_new_tokens=new_tokens)
    t0 = time.perf_counter()
    serve = served(cfg, True)
    arch, tag = serve.arch, f"{key} serve"
    print(f"{tag}: {arch.name} L={arch.n_layers} d_model={arch.d_model} heads "
          f"{arch.n_heads}/{arch.n_kv_heads} head_dim {arch.head_dim} window "
          f"{arch.sliding_window}, {cfg.n_pairs} pairs x {cfg.max_batch} slots, max_len "
          f"{cfg.max_len}; init {time.perf_counter() - t0:.2f} s")
    bad = instrument(serve)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, arch.vocab_size, n).tolist() for n in lens]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = drive(serve, {0: prompts})
    launches = read_counts()
    result = serve_stats(tag, serve, bad, run, launches)
    L, cap = arch.n_layers, serve.engine.pairs[0].lane.cache["k"].shape[2]
    kv_token = 2 * L * arch.n_kv_heads * arch.head_dim * 2
    wrapped = [n for n in lens if n > cap]
    print(f"{tag}: ring of {cap} slots, {len(wrapped)} prompts wrap it {wrapped}; KV "
          f"{kv_token} B a token, {kv_token * cap / 1e6:.1f} MB a slot; K1 launches "
          f"{launches['decode_attention']}, K2 {launches['flash_attention']}")
    if cap != H2O_CAP or not wrapped:
        fail(f"{tag}: ring of {cap} slots, wrapped by {wrapped}")
    for name, calls in (("flash_attention", "prefill_calls"), ("decode_attention", "decode_calls")):
        if launches[name] != L * result[calls] or not result[calls]:
            fail(f"{tag}: {name} launches {launches[name]} != {L} x {result[calls]}")
    wgmma_only(launches, tag, "flash_attention", "decode_attention")
    result.update(prompt_lens=list(lens), ring_capacity=cap, kv_bytes_per_token=kv_token)
    report[tag.replace(" ", "_")] = result
    return launches, serve


# ------------------------------------------------ the MoE models (ROADMAP §1 item 3.3)

# each MoE model's attention heads (H, K, D): G = 8 (qwen3-moe) and 4
# (mixtral, under its window of 4096 on the 4128-slot ring)
MOE_HEADS = {"qwen3-moe-30b-a3b": (32, 4, 128), "mixtral-8x7b": (32, 8, 128)}
# the serves' depth, cut for the call's time limit (eager steps and graph
# capture grow with the layers): mixtral-8x7b at 4 of 32 layers (all 32,
# 93.4 GB of bf16 weights, exceed one card), qwen3-moe-30b-a3b at 8 of 48,
# mamba2-2.7b's serve at 32 of 64, qwen2.5-14b's at 24 of 48,
# h2o-danube-3-4b's at 12 of 24 (llama2-7b's paper serve keeps all 32); the
# two MoE serves are the ones cut to make room for the training checks under
# a mesh
MIXTRAL_LAYERS, QWEN3_MOE_LAYERS = 4, 8
MAMBA_SERVE_LAYERS, QWEN25_SERVE_LAYERS, H2O_SERVE_LAYERS = 32, 24, 12
MOE_NEW_TOKENS = 16
# the mixtral serve's prompts: all eight past the window and the ring
MIXTRAL_LENS = (4500, 5200, 6000, 4800, 5600, 4700, 5900, 5000)
MOE_PROBE: dict = {}  # the MoE layer's device counters while moe_probes() is on
# moe_probes()' marker kernels (a pattern of each one's name) and the part of
# the MoE layer that follows each
MOE_MARKERS = ((r"roll_cuda_kernel", "dispatch and combine"),
               (r"flip_kernel", "expert products"),
               (r"triu_tril_kernel<[^,]+, [^,]+, false", "dispatch and combine"),
               (r"triu_tril_kernel<[^,]+, [^,]+, true", None))


def moe_kernel_phase(report: dict) -> dict:
    """K1, K2 and K3 at the MoE models' heads (``head_checks``): G = 8 at the
    dense serve's 512-slot cache, and G = 4 at D = 128 on mixtral's wrapped
    4128-slot ring under its window.  Then each serve's shapes timed (kernel,
    plain version, SDPA, bound): qwen3-moe's verify at the depth-4 bucket
    (B=8 T=5) and its 512 prefill bucket (4 rows), mixtral's verify on a full
    ring (B=8) and its 8192 prefill bucket under the window; and K3 at G = 8
    (the paged path's decode and admission shapes)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(22)
    err, lines = {}, []
    head_checks(g, MOE_HEADS, err, lines)
    H, K, D = MOE_HEADS["qwen3-moe-30b-a3b"]
    out = {"decode_attention (qwen3-moe verify)": decode_timing(g, 8, 5, 512, H, K, D),
           "flash_attention (qwen3-moe)": flash_timing(g, 4, 512, H, K, D)}
    H, K, D = MOE_HEADS["mixtral-8x7b"]
    out["decode_attention (mixtral verify)"] = decode_timing(g, 8, 5, H2O_CAP, H, K, D,
                                                             window=H2O_WINDOW)
    out["flash_attention (mixtral)"] = flash_timing(g, 1, H2O_LEN, H, K, D, window=H2O_WINDOW)
    for name, r in out.items():
        r["max_abs_err"] = max(err[name.split()[0]], r.pop("err"))
        show_timing(name, r)
    H, K, D = MOE_HEADS["qwen3-moe-30b-a3b"]
    report["moe_paged_timing"] = paged_timing(g, lines, [err["decode_attention_paged"]] * 2,
                                              H, K, D, "qwen3-moe ")
    report["moe_kernel_checks"] = lines
    return out


@contextlib.contextmanager
def routing_recorded():
    """Record every MoE routing call's router and input tokens, by device, in
    call order."""
    from repro_torch.models import moe

    seen = {"cuda": [], "cpu": []}
    route = moe.route

    def recorded(p, cfg, tokens, *losses):
        seen[tokens.device.type].append((p["router"], tokens.detach().clone()))
        return route(p, cfg, tokens, *losses)

    moe.route = recorded
    try:
        yield seen
    finally:
        moe.route = route


def same_routing(tag: str, cfg, seen: dict, report: dict) -> None:
    """The card's routing against the CPU's, call by call (each layer of each
    step): each token's chosen experts and which of them were kept at
    capacity must be identical.  A flip is reported with the CPU's gap
    between the k-th and (k+1)-th router probabilities at that token."""
    import torch

    from repro_torch.models import moe

    if len(seen["cuda"]) != len(seen["cpu"]) or not seen["cuda"]:
        fail(f"{tag}: {len(seen['cuda'])} MoE calls on the card, {len(seen['cpu'])} on the CPU")
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    flips, dropped, total = [], 0, 0
    for call, pair in enumerate(zip(seen["cuda"], seen["cpu"], strict=True)):
        marks = []
        for router, x in pair:
            T = x.shape[0]
            _, top_e = moe.route({"router": router}, cfg, x)
            order, _, _, keep = moe.sort_rank(top_e.reshape(-1), moe.capacity(T, cfg, 1.25))
            kept = torch.empty_like(keep)
            kept[order] = keep
            mark = torch.zeros(T, E, dtype=torch.int8, device=x.device)  # 1 dropped, 2 kept
            marks.append(mark.scatter_(1, top_e, 1 + kept.view(T, K).to(torch.int8)).cpu())
        dropped += int((marks[1] == 1).sum())
        total += pair[1][1].shape[0] * K
        router, x = pair[1]
        probs = torch.softmax(x.float() @ router, -1).sort(-1, descending=True).values
        for t in (marks[0] != marks[1]).any(1).nonzero().flatten().tolist():
            flips.append({"call": call, "token": t,
                          "gap": float(probs[t, K - 1] - probs[t, K])})
    report[tag.replace(" ", "_") + "_routing"] = {"calls": len(seen["cuda"]), "flips": flips,
                                                  "dropped": dropped, "assignments": total}
    print(f"{tag}: routing of {len(seen['cuda'])} MoE calls, {total} assignments: "
          f"{len(flips)} tokens route apart {flips[:8]}; {dropped} assignments dropped at "
          f"capacity on the CPU")
    if flips:
        fail(f"{tag}: the card's routing differs from the CPU's at {len(flips)} tokens")


@contextlib.contextmanager
def moe_probes():
    """Instrument the port's MoE layer for the MoE serves: four marker
    kernels, each an op on a 2 x 2 tensor that the serving path never runs
    and so its own name on the device timeline (MOE_MARKERS: roll at the
    start of every MoE layer, flip and tril around its expert products,
    triu at its end), and device counters of the assignments made and those
    dropped at capacity (two small adds a layer).  Installed before the
    serves are built, so their CUDA graphs capture both; read_counts()
    reports the counters as moe_assignments and moe_dropped."""
    import torch

    from repro_torch.models import moe

    saved = moe.apply_moe, moe.expert_ffn, moe.sort_rank
    t = torch.zeros(2, 2, device="cuda")
    ops = {"roll": lambda: torch.roll(t, 1, 0), "flip": lambda: torch.flip(t, [0]),
           "tril": t.tril, "triu": t.triu}

    def bracketed(fn, before, after):
        def call(*args, **kw):
            ops[before]()
            out = fn(*args, **kw)
            ops[after]()
            return out
        return call

    def counted(flat_e, C):
        out = saved[2](flat_e, C)
        MOE_PROBE["assignments"].add_(flat_e.numel())
        MOE_PROBE["dropped"].add_((~out[3]).sum())
        return out

    MOE_PROBE.update({k: torch.zeros((), dtype=torch.int64, device="cuda")
                      for k in ("assignments", "dropped")})
    moe.apply_moe, moe.expert_ffn, moe.sort_rank = (bracketed(saved[0], "roll", "triu"),
                                                    bracketed(saved[1], "flip", "tril"), counted)
    try:
        yield
    finally:
        moe.apply_moe, moe.expert_ffn, moe.sort_rank = saved
        MOE_PROBE.clear()


def dropped_share(tag: str, launches: dict, result: dict) -> None:
    share = launches["moe_dropped"] / max(launches["moe_assignments"], 1)
    result.update(moe_dropped=launches["moe_dropped"],
                  moe_assignments=launches["moe_assignments"], moe_dropped_share=share)
    print(f"{tag}: {launches['moe_dropped']} of {launches['moe_assignments']} expert "
          f"assignments dropped at capacity ({share:.2%})")


def moe_profile(serve, report: dict, key: str, lens, seed=1) -> None:
    """Where a MoE serve's device time goes: a burst of ``lens`` prompts
    timed plain, then the same burst under torch.profiler (CUDA activity
    only, the raw device events; greedy, so the same device work).  In
    stream order the
    events fall between moe_probes()' markers: inside a MoE layer the
    dispatch and combine ops (routing, sort, rank, the scatter into the
    buffer, the gather and the sum over k, and the drop counters' adds) and
    the expert products (three batched GEMMs over all E experts and the
    activation); outside, K1, K2, K4 (a hybrid's Mamba2 layers), the other
    GEMMs and the rest.  The markers' own time and counts are reported apart
    (equal counts: none was lost; a lost one misplaces the kernels up to the
    next), and the expert products' time a forward (MoE layer calls over
    the MoE layers) beside the time to read every expert's weights once at
    the data sheet's bandwidth."""
    import re
    from collections import Counter

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def burst(s):
        rng = np.random.default_rng(s)
        for n in lens:
            serve.submit(rng.integers(0, serve.arch.vocab_size, n).tolist())
        t0 = time.perf_counter()
        serve.run_until_done()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = burst(seed)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_profiled = burst(seed)
    events = sorted((e.start_ns(), e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    groups = ((r"decode_wgmma_kernel|decode_kernel", "K1"),
              (r"flash_kernel|flash_wgmma_kernel", "K2"),
              (r"ssd_wgmma_kernel|ssd_kernel", "K4"),
              (r"gemm|nvjet|xmma|cutlass", "other GEMMs"))
    ms, marks, region = Counter(), Counter(), None
    for _, ns, name in events:
        mark = next((i for i, (k, _) in enumerate(MOE_MARKERS) if re.search(k, name)), None)
        if mark is not None:
            marks[mark] += 1
            ms["markers"] += ns / 1e6
            region = MOE_MARKERS[mark][1]
            continue
        ms[region or next((g for k, g in groups if re.search(k, name.lower())), "rest")] += ns / 1e6
    busy = sum(ms.values())
    counts = [marks[i] for i in range(len(MOE_MARKERS))]
    if not min(counts) or not ms["expert products"]:
        fail(f"{key}: markers {counts}, {ms['expert products']:.1f} ms of expert products")
    arch, moe = serve.arch, serve.arch.moe
    n_moe = sum(arch.moe_layer_mask())
    forwards = max(counts) / n_moe
    mats = 3 if arch.mlp_type == "swiglu" else 2
    expert_bytes = n_moe * moe.n_experts * mats * arch.d_model * moe.d_ff_expert * 2
    report[key] = {"burst_wall_ms": wall * 1e3, "burst_wall_profiled_ms": wall_profiled * 1e3,
                   "device_busy_ms": busy, "busy_share": busy / (wall * 1e3),
                   "device_ms_by_part": dict(ms.most_common()), "forwards": forwards,
                   "markers": counts,
                   "expert_ms_per_forward": ms["expert products"] / forwards,
                   "expert_read_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
                   "profile_s": time.perf_counter() - t0, "lens": list(lens)}
    print(f"{key}: burst of {len(lens)} requests {wall * 1e3:.1f} ms wall ({wall_profiled * 1e3:.1f}"
          f" ms profiled), device busy {busy:.1f} ms = {busy / (wall * 1e3):.1%} of the wall; "
          f"{forwards:g} forwards; markers {counts}")
    print(f"{key}: device time " + ", ".join(f"{part} {t:.1f} ms ({t / busy:.1%})"
                                             for part, t in ms.most_common()))
    print(f"{key}: expert products {report[key]['expert_ms_per_forward']:.2f} ms a forward; "
          f"every expert's weights ({expert_bytes / 1e9:.2f} GB) read once at 3.35 TB/s: "
          f"{report[key]['expert_read_bound_ms']:.2f} ms")


def moe_phase(report: dict) -> tuple:
    """The MoE serves on the card, with moe_probes() on (each model alone on
    the card, released before the next): qwen3-moe-30b-a3b at full width
    (``QWEN3_MOE_LAYERS`` of its 48 layers, 128 experts top-8) on the dense serve's
    path (2 pairs x 8 slots, max_len 512, 12 requests, 16 new tokens),
    graphed, and a profiled burst; a short sampled serve (4 requests, 8 new
    tokens, temperature 1.0) eager and then graphed on the same weights,
    token for token; mixtral-8x7b at full width and ``MIXTRAL_LAYERS`` of its 32 layers (8
    experts top-2) on a wrapped 4128-slot ring (2 pairs x 8 slots, max_len
    8192, 8 prompts of 4500-6000 tokens), graphed, and a profiled burst.
    Returns both serves' launches."""
    qwen = "qwen3-moe-30b-a3b"
    with moe_probes():
        launches, serve = serve_phase(report, arch=qwen, new_tokens=MOE_NEW_TOKENS,
                                      n_layers=QWEN3_MOE_LAYERS)
        dropped_share(f"{qwen} serve", launches, report[f"{qwen}_serve"])
        moe_profile(serve, report, "qwen3-moe_profile", PROFILE_LENS)
        params = serve.engine.pairs[0].lane.params
        del serve
        release()
        for graphed in (False, True):
            _, serve = serve_phase(report, params, graphed, temperature=1.0, arch=qwen,
                                   new_tokens=8, lens=SERVE_LENS[:4], n_layers=QWEN3_MOE_LAYERS)
            del serve
            release()
        same_as_eager(report, f"{qwen}_sampled_serve")
        del params
        release()
        mixtral_launches, serve = ring_serve_phase(
            report, "mixtral-8x7b", "mixtral", MIXTRAL_LENS, max_batch=8,
            new_tokens=MOE_NEW_TOKENS, n_layers=MIXTRAL_LAYERS)
        dropped_share("mixtral serve", mixtral_launches, report["mixtral_serve"])
        moe_profile(serve, report, "mixtral_profile", MIXTRAL_LENS[:4], seed=15)
        del serve
        release()
    return launches, mixtral_launches


# ------------------------------------------- encoder-decoder and vision prefix

ENCDEC_HEADS = {"seamless-m4t-large-v2": (16, 16, 64), "internvl2-1b": (14, 2, 64)}
SEAMLESS_FRAMES, SEAMLESS_PROMPT, SEAMLESS_MAX_LEN = 1024, 64, 512
INTERNVL_PATCHES, INTERNVL_PROMPT, INTERNVL_MAX_LEN = 256, 256, 1024
ENCDEC_B, ENCDEC_NEW_TOKENS = 4, 32
# memory lengths of the K1 cross checks: full, ragged, one, none
MEM_LENS = [1024, 1000, 513, 64, 1, 0, 700, 257]


def encdec_kernel_phase(report: dict) -> dict:
    """K1 and K2 as the encoder-decoder and the vision-prefix model call them:
    K1 not causal (cross attention; bf16 and fp32) at seamless's heads (B=8,
    H = K = 16, D = 64) over 1,024 memory slots for T = 1, 5 and 300, rows
    whose memory holds 1,024 down to 0 valid slots, the K/V past each row's
    length poisoned (an unmasked slot would show); K2 not causal (the
    encoder; bf16 and fp32) at B=2 over 1,024 and a ragged 100 frames; then
    K1-K3 at internvl2's G = 7, D = 64 (``head_checks``).  Each serve shape
    timed (kernel, plain version, SDPA, bound).  Every bf16 call on the
    tensor-core kernel, every fp32 call on the CUDA-core one."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda as k1
    from repro_torch.kernels.decode_attention import dense_positions
    from repro_torch.kernels.flash_attention import flash_attention_cuda as k2

    g = torch.Generator(device="cuda").manual_seed(25)
    err, lines = {}, []
    H, K, D = ENCDEC_HEADS["seamless-m4t-large-v2"]
    S = SEAMLESS_FRAMES
    mem_len = torch.tensor(MEM_LENS, dtype=torch.int32, device="cuda")
    pos = dense_positions(mem_len, S)
    for T in (1, 5, 300):
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            q = torch.randn(8, T, H, D, generator=g, device="cuda").to(dtype)
            k, v = (torch.randn(8, S, K, D, generator=g, device="cuda").to(dtype)
                    for _ in range(2))
            for b, n in enumerate(MEM_LENS):  # past the memory: poison
                k[b, n:], v[b, n:] = 60.0, -60.0
            before = k1.wgmma_launches
            got = k1(q, k, v, mem_len, kv_positions=pos, causal=False)
            if k1.wgmma_launches - before != int(dt == "bfloat16"):
                fail(f"cross decode_attention T={T} {dt}: took the wrong kernel")
            e = check(f"cross decode_attention T={T} {dt}", got,
                      ref.decode_attention(q, k, v, mem_len, kv_positions=pos, causal=False), dt)
            if dt == "bfloat16":
                err["decode_attention"] = max(err.get("decode_attention", 0.0), e)
            lines.append(f"decode_attention not causal B=8 T={T} S={S} H={H} K={K} D={D} {dt} "
                         f"mem_len {MEM_LENS}: max_abs_err={e:.3g}")
    for B, Sq, dt in ((2, 1024, "bfloat16"), (2, 100, "bfloat16"), (2, 1024, "float32"),
                      (2, 100, "float32")):
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(B, Sq, n, D, generator=g, device="cuda").to(dtype)
                   for n in (H, K, K))
        before = k2.wgmma_launches
        got = k2(q, k, v, causal=False)
        if k2.wgmma_launches - before != int(dt == "bfloat16"):
            fail(f"encoder flash_attention S={Sq} {dt}: took the wrong kernel")
        e = check(f"encoder flash_attention S={Sq} {dt}", got,
                  ref.flash_attention(q, k, v, causal=False), dt)
        if dt == "bfloat16":
            err["flash_attention"] = max(err.get("flash_attention", 0.0), e)
        lines.append(f"flash_attention not causal B={B} S={Sq} H={H} K={K} D={D} {dt}: "
                     f"max_abs_err={e:.3g}")
    for line in lines:
        print(line)
    head_checks(g, {"internvl2-1b": ENCDEC_HEADS["internvl2-1b"]}, err, lines)

    # ---- timing at the serves' shapes: seamless's encoder, decoder prefill
    # and its cross call, a decode step's self and cross calls; internvl2's
    # prefill (256 patches + 256 tokens) and decode step
    B, F, P = ENCDEC_B, SEAMLESS_FRAMES, SEAMLESS_PROMPT
    out = {"flash_attention (seamless encoder)": flash_timing(g, B, F, H, K, D, causal=False),
           "flash_attention (seamless decoder prefill)": flash_timing(g, B, P, H, K, D),
           "decode_attention (seamless cross prefill)": decode_timing(g, B, P, F, H, K, D,
                                                                      causal=False),
           "decode_attention (seamless cross decode)": decode_timing(g, B, 1, F, H, K, D,
                                                                     causal=False),
           "decode_attention (seamless self decode)": decode_timing(g, B, 1, SEAMLESS_MAX_LEN,
                                                                    H, K, D)}
    H, K, D = ENCDEC_HEADS["internvl2-1b"]
    out["flash_attention (internvl2 prefill)"] = flash_timing(
        g, B, INTERNVL_PATCHES + INTERNVL_PROMPT, H, K, D)
    out["decode_attention (internvl2 decode)"] = decode_timing(g, B, 1, INTERNVL_MAX_LEN, H, K, D)
    for name, r in out.items():
        r["max_abs_err"] = max(err[name.split()[0]], r.pop("err"))
        show_timing(name, r)
    report["encdec_kernel_checks"] = lines
    return out


@contextlib.contextmanager
def calls_by_mask():
    """Count the model's attention calls on the card by kernel and mask
    (``decode_attention``/``flash_attention``, causal or not) while on."""
    from repro_torch.kernels import ops

    seen = {}
    wrapped = {name: getattr(ops, name) for name in ("decode_attention", "flash_attention")}

    def counting(name):
        def call(*args, causal=True, **kw):
            key = f"{name}.{'causal' if causal else 'not_causal'}"
            seen[key] = seen.get(key, 0) + 1
            return wrapped[name](*args, causal=causal, **kw)
        return call

    for name in wrapped:
        setattr(ops, name, counting(name))
    try:
        yield seen
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)


def encdec_inputs(cfg, B, n_text, gen, device, n_front=None):
    """A batch of seeded stub inputs: n_text tokens a row, and the
    frontend's frames (encoder-decoder) or patches, n_front a row (default
    ``cfg.frontend.n_tokens``), N(0, 1) in the model's dtype."""
    import torch

    n_front = n_front or cfg.frontend.n_tokens
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, n_text), generator=gen,
                                     dtype=torch.int32)}
    stub = torch.randn(B, n_front, cfg.d_model, generator=gen).to(getattr(torch, cfg.dtype))
    batch["frames" if cfg.is_encdec else "patches"] = stub
    return {k: v.to(device) for k, v in batch.items()}


def encdec_model_phase(report: dict, arch: str) -> None:
    """The model at full width and 2 layers (seamless also 2 encoder layers)
    on the card against the same weights on the CPU, float32: a prefill (2
    rows of 64 tokens behind 1,024 frames, or 256 patches), a 5-token verify,
    a commit at per-row accept indices and a plain step.  Logits within
    1e-3, kv_pos equal, the cross memory within 1e-3; every K1 and K2 launch
    on the CUDA-core kernels."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32",
                              n_encoder_layers=min(get_config(arch).n_encoder_layers, 2))
    gpu, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    params = gpu.init(1)
    for layer in params["layers"]:  # the seeded init leaves QKV biases zero
        for name in ("bq", "bk", "bv"):
            if name in layer["attn"]:
                layer["attn"][name].normal_(0.0, 0.5)
    cpu_params = to_cpu(params)
    gen = torch.Generator().manual_seed(5)
    batch = encdec_inputs(cfg, 2, 64, gen, "cpu", SEAMLESS_FRAMES if cfg.is_encdec else None)
    zero_counts()
    lg, cg = gpu.prefill(params, {k: v.cuda() for k, v in batch.items()}, 512)
    lc, cc = cpu.prefill(cpu_params, batch, 512)
    errs = [max_err(lg.cpu(), lc)]
    names = ("cross_k", "cross_v") if cfg.is_encdec else ()
    errs += [max_err(cg[n].cpu(), cc[n]) for n in names]
    for T, accept in ((5, torch.tensor([1, 4], dtype=torch.int32)), (1, None)):
        step = torch.randint(0, cfg.vocab_size, (2, T), generator=gen, dtype=torch.int32)
        errs.append(max_err(gpu.decode_step(params, cg, step.cuda()).cpu(),
                            cpu.decode_step(cpu_params, cc, step)))
        if not torch.equal(cg["kv_pos"].cpu(), cc["kv_pos"]):
            fail(f"{arch} model check: kv_pos differs between the card and the CPU")
        if accept is not None:
            gpu.commit_cache(cg, cg["len"] - T, accept.cuda())
            cpu.commit_cache(cc, cc["len"] - T, accept)
    launches = read_counts()
    tag = f"{arch} model check"
    print(f"{tag} (full width, 2 layers{', 2 encoder layers' if cfg.is_encdec else ''}, fp32, "
          f"card vs CPU): max_abs_err={max(errs):.3g}; launches {launches}")
    for name in ("decode_attention", "flash_attention"):
        no_wgmma(launches, name, tag)
    if max(errs) > 1e-3:
        fail(f"{tag}: logits or cross memory differ by {max(errs):.3g} > 1e-3")
    report[f"{arch}_model_check_max_abs_err"] = max(errs)


def device_busy_ms(fn) -> float:
    """Device time (kernels and copies, from the profiler's raw records) of
    one call of fn, synchronised."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA) / 1e6


def greedy(model, params, cache, logits, n):
    """n greedy tokens a row from the prefill's last logits (B, V), one
    decode step each; returns the (B, n) tokens and the mean ms a step."""
    import torch

    tok, out = logits.argmax(-1).to(torch.int32), []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out.append(tok)
        tok = model.decode_step(params, cache, tok[:, None])[:, 0].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    return torch.stack(out, 1), (time.perf_counter() - t0) / n * 1e3


def encdec_phase(report: dict, arch: str) -> dict:
    """The model at full width and depth in bf16 on the card, through
    ``build_model`` (no engine serves it: no request carries frames or
    patches): 4 rows of seeded stub frames (seamless: 1,024 a row, 64-token
    prompts) or patches (internvl2: 256 a row, 256-token prompts), a
    prefill and 32 greedy tokens.  K1 and K2 launches per prefill and per
    decode step, split by mask (seamless: 24 + 24 K2 and 24 cross K1 a
    prefill, 24 self + 24 cross K1 a step), every one on the tensor-core
    kernels; tokens in the vocabulary and finite logits; ms per prefill and
    per step (host clock), and the device time of one more of each under the
    profiler (their busy share), the encoder's part of seamless's prefill;
    peak memory.  Then
    the rollback check: a 5-token verify committed to k = 2 and a probe step
    against a second copy of the prefill's cache that decodes only the first
    k + 1 tokens before the same probe: logits within 2e-2.  Returns the
    launches of the prefill and of the 32 steps."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    L = cfg.n_layers
    model = build_model(cfg, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(7)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    seamless = cfg.is_encdec
    n_text, max_len = ((SEAMLESS_PROMPT, SEAMLESS_MAX_LEN) if seamless
                       else (INTERNVL_PROMPT, INTERNVL_MAX_LEN))
    batch = encdec_inputs(cfg, ENCDEC_B, n_text, torch.Generator().manual_seed(6), "cuda",
                          SEAMLESS_FRAMES if seamless else INTERNVL_PATCHES)
    with torch.no_grad():
        model.prefill(params, batch, max_len)  # warm: cuBLAS handles, kernels loaded
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with calls_by_mask() as pre_calls:
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, batch, max_len)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
        pre = read_counts()
        enc_ms = None
        if seamless:
            t0 = time.perf_counter()
            model._encode(params, batch["frames"])
            torch.cuda.synchronize()
            enc_ms = (time.perf_counter() - t0) * 1e3
        saved = {name: t.clone() for name, t in cache.items()}
        zero_counts()
        with calls_by_mask() as step_calls:
            tokens, step_ms = greedy(model, params, cache, logits, ENCDEC_NEW_TOKENS)
        steps = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        dev = {"prefill": device_busy_ms(lambda: model.prefill(params, batch, max_len)),
               "step": device_busy_ms(lambda: model.decode_step(params, cache, tokens[:, -1:]))}
        if seamless:
            dev["encoder"] = device_busy_ms(lambda: model._encode(params, batch["frames"]))
        # rollback: verify 5, keep k + 1, probe; against decoding only k + 1
        k, gen = 2, torch.Generator().manual_seed(8)
        toks = torch.randint(0, cfg.vocab_size, (ENCDEC_B, 6), generator=gen,
                             dtype=torch.int32).cuda()
        a, b = saved, {name: t.clone() for name, t in saved.items()}
        model.decode_step(params, a, toks[:, :5])
        model.commit_cache(a, a["len"] - 5, torch.full((ENCDEC_B,), k, dtype=torch.int32,
                                                        device="cuda"))
        model.decode_step(params, b, toks[:, :k + 1])
        rollback = max_err(model.decode_step(params, a, toks[:, 5:]),
                           model.decode_step(params, b, toks[:, 5:]))
    tag = f"{arch} (full width, {L} layers" + (f" + {cfg.n_encoder_layers} encoder layers"
                                               if seamless else "") + ", bf16)"
    want_pre = {"flash_attention.causal": L} | (
        {"flash_attention.not_causal": cfg.n_encoder_layers, "decode_attention.not_causal": L}
        if seamless else {})
    want_step = {"decode_attention.causal": L} | (
        {"decode_attention.not_causal": L} if seamless else {})
    want_step = {key: n * ENCDEC_NEW_TOKENS for key, n in want_step.items()}
    if pre_calls != want_pre or step_calls != want_step:
        fail(f"{tag}: attention calls {pre_calls} a prefill (want {want_pre}), {step_calls} in "
             f"{ENCDEC_NEW_TOKENS} steps (want {want_step})")
    for launches, when in ((pre, "prefill"), (steps, "decode")):
        wgmma_only(launches, f"{tag} {when}", "flash_attention", "decode_attention")
        for name in ("flash_attention", "decode_attention"):
            if launches[name] != sum(n for key, n in (pre_calls if when == "prefill"
                                                      else step_calls).items()
                                     if key.startswith(name)):
                fail(f"{tag} {when}: {launches[name]} {name} launches")
    if not bool(torch.isfinite(logits).all()) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        fail(f"{tag}: non-finite logits or a token outside the vocabulary")
    if rollback > 2e-2:
        fail(f"{tag}: a verify committed to k = {k} differs from decoding k + 1 tokens "
             f"by {rollback:.3g} > 2e-2")
    result = {"init_s": init_s, "prefill_ms": prefill_ms, "encoder_ms": enc_ms,
              "step_ms": step_ms, "device_ms": dev, "step_busy_share": dev["step"] / step_ms,
              "prefill_busy_share": dev["prefill"] / prefill_ms, "peak_gb": peak,
              "rollback_max_abs_err": rollback,
              "calls_per_prefill": pre_calls,
              "calls_per_step": {key: n // ENCDEC_NEW_TOKENS for key, n in step_calls.items()},
              "n_params": cfg.n_params(), "rows": ENCDEC_B, "prompt": n_text,
              "frontend_tokens": batch.get("frames", batch.get("patches")).shape[1],
              "new_tokens": ENCDEC_NEW_TOKENS, "max_len": max_len,
              "tokens": tokens.tolist()}
    report[f"{arch}_run"] = result
    print(f"{tag}: {ENCDEC_B} rows x ({result['frontend_tokens']} "
          f"{'frames' if seamless else 'patches'} + {n_text} tokens), init {init_s:.2f} s; "
          f"prefill {prefill_ms:.2f} ms" + (f" (the encoder alone {enc_ms:.2f} ms)" if seamless
                                            else "")
          + f", {ENCDEC_NEW_TOKENS} greedy steps {step_ms:.2f} ms each; device time a prefill "
          f"{dev['prefill']:.2f} ms ({result['prefill_busy_share']:.1%} busy"
          + (f"; the encoder {dev['encoder']:.2f} ms, {dev['encoder'] / dev['prefill']:.1%} of "
             "it" if seamless else "")
          + f"), a step {dev['step']:.2f} ms ({result['step_busy_share']:.1%} busy); attention "
          f"calls a prefill {pre_calls}, a step {result['calls_per_step']}; peak {peak:.2f} GB; "
          f"rollback max_abs_err={rollback:.3g}")
    return {"prefill": pre, "decode": steps, "pre_calls": pre_calls, "step_calls": step_calls}


def cross_grad_refused() -> None:
    """K1 (serving's cross attention) on CUDA tensors under autograd raises
    (it has no backward) and launches nothing.  Training's cross attention
    takes its gradient through K2 (phase 14)."""
    import torch

    from repro_torch.kernels import ops

    q = torch.zeros(1, 2, 16, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros(1, 64, 16, 64, device="cuda", dtype=torch.bfloat16)
    zero_counts()
    try:
        ops.decode_attention(q, k, k, torch.full((1,), 64, dtype=torch.int32, device="cuda"),
                             causal=False)
        fail("cross attention under autograd on the card did not raise")
    except NotImplementedError as e:
        if read_counts()["decode_attention"]:
            fail("a refused cross-attention call launched K1")
        print(f"K1 (serving's cross attention) under autograd refused on the card: {e}")


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
    (4, 2048, 80, 64, 1, 128, "bfloat16", False),  # mamba2-2.7b's training shape
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


def ssd_kernel_phase(report: dict, checks=SSD_CHECKS, heads: int = 80,
                     key: str = "ssd_kernel_checks", seed: int = 4) -> dict:
    """K4 against its plain version on ``checks`` (y and final state; bf16 on
    ssd_wgmma_kernel, fp32 on ssd_kernel), then checked and timed at the
    serve shape (a 400-token prompt) and at the training shape (B = 4, S =
    2048) with ``heads`` heads (mamba2-2.7b's 80, jamba's 256) on views
    rotated past the L2; returns both timings by "serve" and "train"."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    err, lines = 0.0, []
    for B, S, H, P, G, N, dt, init in checks:
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
    out, H = {}, heads
    for part, B, S in (("serve", 1, 400), ("train", 4, 2048)):  # the serve's and training's shapes
        sets = copies(lambda: ssd_case(g, B, S, H, 64, 1, 128, "bfloat16"),  # noqa: B023
                      B * S * (H * 64 * 2 + 256 * 2 + H * 4))
        nbytes, ops = ssd_cost(sets[0][0], sets[0][3], None)
        wy, ws = ref.ssd_scan(*sets[0][:5], chunk=256)
        y, sf = ssd_scan_cuda(*sets[0][:5])
        e = max(check(f"ssd_scan timing set {part}", y, wy, "bfloat16", SSD_TOL),
                check(f"ssd_scan timing set {part} state", sf, ws, "bfloat16", SSD_TOL))
        same_bits(f"ssd_scan B={B} S={S} H={H}",
                  lambda: ssd_scan_cuda(*sets[0][:5]))  # noqa: B023

        def scan(i, plain=False, sets=sets):
            args = sets[i % len(sets)][:5]
            return ref.ssd_scan(*args, chunk=256) if plain else ssd_scan_cuda(*args)

        r = out[part] = {
            "shape": f"B={B} S={S} H={H} P=64 G=1 N=128 bf16 (strided views)",
            "ms": timed(scan, 200),
            "plain_ms": timed(lambda i, f=scan: f(i, plain=True), 20 if part == "serve" else 3),
            "library_ms": None, "bound": bound_ms(nbytes, ops, "bfloat16"),
            "max_abs_err": max(err, e)}
        was = (f" (previous kernel {PREVIOUS_MS['ssd_scan']} ms)"
               if (part, H) == ("serve", 80) else "")
        print(f"ssd_scan [{r['shape']}]: kernel {r['ms']:.4f} ms{was}, plain {r['plain_ms']:.4f} "
              f"ms, no single PyTorch call, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
        del sets, wy, ws, y, sf
    report[key] = lines
    return out


# (B, S, H, P, G, N, dtype): mamba2-2.7b's training shape in both dtypes, 2
# groups with a ragged tail, a prompt shorter than 8, 4 groups of 4 heads,
# and the reduced config's heads (P = 32, N = 16)
SSD_BWD_CHECKS = [(4, 2048, 80, 64, 1, 128, "bfloat16"), (4, 2048, 80, 64, 1, 128, "float32"),
                  (2, 300, 16, 64, 2, 128, "bfloat16"), (2, 300, 16, 64, 2, 128, "float32"),
                  (1, 5, 80, 64, 1, 128, "bfloat16"), (1, 5, 80, 64, 1, 128, "float32"),
                  (1, 48, 16, 32, 4, 16, "float32"), (2, 40, 8, 32, 1, 16, "float32")]
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC")


def ssd_bwd_cost(x, Bm, chunk=64):
    """(bytes, ops) of the backward: x, dt, A, B, C and dy read once, dx, ddt,
    dA, dB and dC written once; the products at the kernel's 64-row chunks:
    C.B a group, and a head's dy.x over the causal half, the transposed
    intra-chunk forms of dx, dB and dC over it, their three terms through
    the state or its gradient, the gradient's step back and the forward's
    state update, recomputed."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    esz = x.element_size()
    nbytes = 3 * x.numel() * esz + 4 * Bm.numel() * esz + 2 * B * S * H * 4 + 2 * H * 4
    ops = 0
    for c0 in range(0, S, chunk):
        c = min(chunk, S - c0)
        ops += 2 * c * c * N * G + H * (2 * c * (c + 1) * P + 2 * c * (c + 1) * N + 10 * c * P * N)
    return nbytes, B * ops


def plain_ssd_grads(x, dtv, A, Bm, C, dy, dtype=None):
    """The plain scan's gradients by autograd (y's; the final state takes
    none), in x's dtype widened to float32 as the plain version computes,
    or in ``dtype`` (float64: the exact oracle of the fp32 kernel)."""
    import torch

    from repro_torch.kernels import ref

    leaves = [t.detach().to(dtype or t.dtype).requires_grad_() for t in (x, dtv, A, Bm, C)]
    y, _ = ref.ssd_scan(*leaves, chunk=256)
    return torch.autograd.grad(y, leaves, dy.to(dtype or dy.dtype))


def ssd_bwd_phase(report: dict, checks=SSD_BWD_CHECKS, shape=(4, 2048, 80, 64, 1, 128),
                  key: str = "ssd_bwd", seed: int = 12) -> dict:
    """K4's backward (``ssd_scan_bwd.cu``) against the plain scan's autograd
    on ``checks``, every gradient (dx, ddt, dA, dB, dC), on the model's
    strided views: fp32 elementwise within SSD_TOL (tol + tol*|b|) of the
    plain version run in float64, but ddt within tol * (1 + max |b|) (its
    elementwise reading reported: at the training shape ddt reaches ~900
    from terms that cancel, and the fp32 plain version itself reads 3x the
    elementwise bound against float64; the kernel 1.3x); bf16 elementwise
    within SSD_TOL of the
    plain version's autograd (fp32 arithmetic on the bf16 inputs) and each
    gradient row within BWD_ROW_TOL of its RMS, with a control that must
    fail that check (the plain gradients with the last chunk's dy of head 0
    zeroed); every bf16 launch on ssd_bwd_wgmma_kernel and every fp32 one on
    ssd_bwd_kernel.  At the training ``shape`` (bf16; mamba2-2.7b's H = 80 or
    jamba's 256): two calls bit for bit, then the backward and the plain
    version's backward timed on inputs rotated past the L2."""
    import torch

    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    errs, rows, lines, control = {}, {}, [], None
    for B, S, H, P, G, N, dt in checks:
        tag = f"ssd_scan_bwd B={B} S={S} H={H} P={P} G={G} N={N} {dt}"
        x, dtv, A, Bm, C, _ = ssd_case(g, B, S, H, P, G, N, dt)
        dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
        before = ssd_scan_bwd_cuda.wgmma_launches
        got = ssd_scan_bwd_cuda(x, dtv, A, Bm, C, dy)
        if ssd_scan_bwd_cuda.wgmma_launches - before != int(dt == "bfloat16"):
            fail(f"{tag}: took the wrong kernel")
        want = plain_ssd_grads(x, dtv, A, Bm, C, dy, torch.float64 if dt == "float32" else None)
        here = {}
        for name, a, b in zip(SSD_GRADS, got, want, strict=True):
            if dt == "float32" and name == "ddt":
                e, tol = max_err(a, b), SSD_TOL[dt]
                here["ddt elementwise"] = float(((a - b).abs() / (tol + tol * b.abs())).max())
                if not torch.isfinite(a).all() or e > tol * (1 + float(b.abs().max())):
                    fail(f"{tag}: ddt off by {e:.3g} (max |ddt| {float(b.abs().max()):.3g})")
            else:
                e = check(f"{tag}: {name}", a, b, dt, SSD_TOL)
            errs[dt] = max(errs.get(dt, 0.0), e)
            if dt == "bfloat16":
                here[name] = row_err(a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1]))
                rows[name] = max(rows.get(name, 0.0), here[name])
        lines.append(f"{tag}: every gradient within {SSD_TOL[dt]} of the plain version" + (
            f" in float64 (ddt's elementwise reading {here.pop('ddt elementwise'):.3g} of tol + "
            "tol*|b|)" if dt == "float32" else "; row errors " + ", ".join(
                f"{n} {v:.4g}" for n, v in here.items())))
        print(lines[-1])
        if here and max(here.values()) > BWD_ROW_TOL[dt]:
            fail(f"{tag}: a gradient row differs by more than {BWD_ROW_TOL[dt]} of its RMS")
        if here and control is None:
            cut = dy.clone()
            cut[:, (-(-S // 64) - 1) * 64:, 0] = 0
            drop = plain_ssd_grads(x, dtv, A, Bm, C, cut)
            control = {f"{SSD_GRADS[i]}{part}": row_err(drop[i][:, r].flatten(0, -2),
                                                         want[i][:, r].flatten(0, -2))
                       for i in (0, 3, 4)
                       for part, r in (("", slice(None)), (" first half", slice(0, S // 2)))}
            print("K4 backward row check's control (the last chunk's dy of head 0 zeroed): "
                  + ", ".join(f"{k} {v:.4g}" for k, v in control.items()))
            if max(control["dx"], control["dB"], control["dC"]) <= BWD_ROW_TOL[dt]:
                fail("K4 backward: the row check cannot tell a dropped chunk")
        del got, want
    torch.cuda.synchronize()
    B, S, H = shape[:3]

    def make():
        x, dtv, A, Bm, C, _ = ssd_case(g, *shape, "bfloat16")
        return x, dtv, A, Bm, C, torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)

    sets = copies(make, S * B * (H * 64 * 2 * 2 + 256 * 2 + H * 4))
    same_bits(f"K4 backward at B={B} S={S} H={H}", lambda: ssd_scan_bwd_cuda(*sets[0]))
    nbytes, ops = ssd_bwd_cost(sets[0][0], sets[0][3])
    out = {"shape": f"B={B} S={S} H={H} P=64 G=1 N=128 bf16 (strided views)",
           "ms": timed(lambda i: ssd_scan_bwd_cuda(*sets[i % len(sets)]), 10),
           "plain_ms": timed(lambda i: plain_ssd_grads(*sets[i % len(sets)]), 3),
           "library_ms": None, "bound": bound_ms(nbytes, ops, "bfloat16"),
           "max_abs_err": errs["bfloat16"]}
    was = f" (previous kernel {PREVIOUS_MS['ssd_scan_bwd']} ms)" if H == 80 else ""
    print(f"ssd_scan_bwd [{out['shape']}]: kernel {out['ms']:.4f} ms{was}, plain (autograd) "
          f"{out['plain_ms']:.4f} ms, library none: no single PyTorch call, bound "
          f"{out['bound'][0]:.4f} ms ({out['bound'][1]})")
    report[key] = {"checks": lines, "errs": errs, "row_errs": rows, "control": control,
                         **{k: v for k, v in out.items() if k != "bound"},
                         "bound": list(out["bound"])}
    return out


def to_cpu(tree, device="cpu"):
    """A copy of a weight tree on ``device`` (the CPU by default)."""
    if isinstance(tree, dict):
        return {k: to_cpu(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v, device) for v in tree]
    return tree.to(device)


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
    16-400 tokens, 16 new tokens each (the time limit: an eager mamba2 step
    takes ~0.4 s).  Every admission is its own exact-shape prefill call, which
    runs K4 once per layer."""
    import numpy as np
    import torch

    from repro_torch.api import ServeConfig

    cfg = ServeConfig(arch="mamba2-2.7b", reduced=False, n_pairs=2, max_batch=8, max_len=512,
                      max_new_tokens=16, n_layers=MAMBA_SERVE_LAYERS)
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


# ------------------------------------------- jamba-1.5-large-398b (the hybrid)

JAMBA = "jamba-1.5-large-398b"
JAMBA_HEADS = (64, 8, 128)  # attention H, K, D; Mamba2 at 256 heads of P = 64, N = 128
# Runs of consecutive layers of jamba's first 8-layer block that end at its
# attention layer (7) and fit one card, cut kind for kind (layer i of the run
# is attention iff i % attn_period == attn_period - 1, MoE iff i is odd):
# layers 4-7 (ssm+MLP, ssm+MoE, ssm+MLP, attn+MoE; 45.96 GB of bf16 weights
# with the embeddings) serve; layers 6-7 (23.80 GB bf16, 47.6 GB fp32)
# train and are held against the CPU.  A whole block is 88.1 GB: every MoE
# layer holds 19.3 GB of experts.
JAMBA_CUTS = {"serve": {"n_layers": 4, "attn_period": 4, "scan_block": 4},
              "train": {"n_layers": 2, "attn_period": 2, "scan_block": 2}}
JAMBA_SSD_CHECKS = [(1, 400, 256, 64, 1, 128, "bfloat16", False),  # the serve's longest prompt
                    (1, 400, 256, 64, 1, 128, "float32", True),
                    (1, 33, 256, 64, 1, 128, "bfloat16", False),
                    (4, 2048, 256, 64, 1, 128, "bfloat16", False)]  # the training shape
JAMBA_SSD_BWD_CHECKS = [(4, 2048, 256, 64, 1, 128, "bfloat16"),
                        (1, 1024, 256, 64, 1, 128, "float32")]
JAMBA_BWD_CASES = [(4, 2048, 64, 8, 128, "bfloat16", None), (1, 2048, 64, 8, 128, "float32", None)]


def jamba_cfg(cut: str, **fields):
    """jamba-1.5-large-398b at full width, cut to the layer run ``cut``."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(JAMBA), **JAMBA_CUTS[cut], **fields)


def jamba_kernel_phase(report: dict) -> dict:
    """(a) jamba's kernels at its shapes: K1, K2 (and K3, which the hybrid
    does not run: paged KV is attention-only) at H = 64, K = 8, D = 128
    against their plain versions (``head_checks``); K1 timed at the serve's
    widest verify (B=8 T=9 S=512: 72 query rows a KV head) and K2 at its
    longest exact-shape admission (B=1 S=400), each also bit for bit on
    repeat; K2's backward and its forward with lse at B=4 S=2048 in both
    dtypes, rows and a control, bit for bit, timed (``train_kernel_phase``);
    K4 forward and backward at 256 heads (``ssd_kernel_phase``,
    ``ssd_bwd_phase``): the serve's and the training shapes, both dtypes,
    bit for bit, timed.  Returns the timing rows by name."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    g = torch.Generator(device="cuda").manual_seed(31)
    err, lines = {}, []
    head_checks(g, {JAMBA: JAMBA_HEADS}, err, lines)
    H, K, D = JAMBA_HEADS
    out = {"decode_attention (jamba verify)": decode_timing(g, 8, 9, 512, H, K, D),
           "flash_attention (jamba prefill)": flash_timing(g, 1, 400, H, K, D)}
    for name, r in out.items():
        r["max_abs_err"] = max(err[name.split()[0]], r.pop("err"))
        show_timing(name, r)
    q, k, v, clen, pos = decode_case(g, 8, 9, 512, H, K, D, "bfloat16", [500] * 8)
    same_bits("K1 at jamba's verify", lambda: decode_attention_cuda(q, k, v, clen,
                                                                     kv_positions=pos))
    q, k, v = (torch.randn(1, 400, n, D, generator=g, device="cuda").to(torch.bfloat16)
               for n in (H, K, K))
    same_bits("K2 at jamba's admission", lambda: flash_attention_cuda(q, k, v))
    report["jamba_kernel_checks"] = lines
    train = train_kernel_phase(report, JAMBA_BWD_CASES, ((" jamba", H, K),),
                               "jamba_train_kernels", 32)
    out["flash_attention_bwd (jamba training)"] = train["bwd jamba"]
    out["flash_attention (jamba training, lse)"] = train["fwd jamba"]
    ssd = ssd_kernel_phase(report, JAMBA_SSD_CHECKS, 256, "jamba_ssd_kernel_checks", 33)
    out["ssd_scan (jamba prefill)"], out["ssd_scan (jamba training)"] = ssd["serve"], ssd["train"]
    out["ssd_scan_bwd (jamba training)"] = ssd_bwd_phase(
        report, JAMBA_SSD_BWD_CHECKS, (4, 2048, 256, 64, 1, 128), "jamba_ssd_bwd", 34)
    return out


def jamba_model_phase(report: dict) -> None:
    """(b) jamba's layers 6-7 (Mamba2 + MLP, attention + MoE) at full width,
    float32, on the card against the same weights on the CPU (47.6 GB on
    each side): an exact-shape prefill of 2 rows of 64 tokens, a 5-token
    verify, a per-row commit and a plain step; each token's chosen experts
    and its keep mask at capacity identical, call by call (``same_routing``),
    then the logits and the committed SSM state within 1e-3.  Every fp32
    launch of K1, K2 and K4 on its CUDA-core kernel."""
    import torch

    from repro_torch.models import build_model

    cfg = jamba_cfg("train", dtype="float32")
    gpu, cpu = build_model(cfg, "cuda"), build_model(cfg, "cpu")
    t0 = time.perf_counter()
    params = gpu.init(1)
    cpu_params = to_cpu(params)
    made = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, dtype=torch.int32)
    zero_counts()
    with routing_recorded() as seen:
        lg, cg = gpu.prefill(params, {"tokens": tokens.cuda()}, 128)
        lc, cc = cpu.prefill(cpu_params, {"tokens": tokens}, 128)
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
    tag = "jamba model check"
    same_routing(tag, cfg, seen, report)
    print(f"{tag} (layers 6-7 at full width, fp32, card vs CPU; weights made and copied in "
          f"{made:.1f} s): max_abs_err={max(errs):.3g}; launches {launches}")
    for name in ("decode_attention", "flash_attention", "ssd_scan"):
        no_wgmma(launches, name, tag)
    if max(errs) > 1e-3:
        fail(f"{tag}: logits or state differ by {max(errs):.3g} > 1e-3")
    report["jamba_model_check"] = {"max_abs_err": max(errs), "launches": launches,
                                   "weights_s": made}


def jamba_serve_phase(report: dict, params=None, graphed=True):
    """(c) jamba's layers 4-7 at full width, bf16, on 2 pairs x 8 slots
    (max_len 512, the n-gram draft with SpecuStream, greedy): the dense
    serve's 12 prompts, 32 new tokens each.  Every admission is its own
    exact-shape prefill (the stack is not attention-only): K4 once a Mamba2
    layer and K2 once the attention layer; every decode and verify step K1
    once.  Every launch on the tensor-core kernels, no other kernel; the
    MoE layers' drops counted (moe_probes).  Returns (launches, serve)."""
    import numpy as np
    import torch

    from repro_torch.api import ServeConfig

    cfg = ServeConfig(arch=JAMBA, reduced=False, n_pairs=2, max_batch=8, max_len=512,
                      max_new_tokens=32)
    t0 = time.perf_counter()
    serve = served(cfg, graphed, arch_cfg=jamba_cfg("serve"),
                   **({} if params is None else {"params": params}))
    torch.cuda.synchronize()
    arch = serve.arch
    print(f"jamba serve: layers 4-7 of {JAMBA} ({arch.layer_kinds()}, MoE "
          f"{arch.moe_layer_mask()}) d_model={arch.d_model} vocab={arch.vocab_size} "
          f"{arch.dtype}, {cfg.n_pairs} pairs x {cfg.max_batch} slots; init "
          f"{time.perf_counter() - t0:.2f} s")
    bad = instrument(serve)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, arch.vocab_size, n).tolist() for n in SERVE_LENS]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    run = drive(serve, {0: prompts[:8], 3: prompts[8:]})
    launches = read_counts()
    tag = "jamba serve" + ("" if graphed else " (eager)")
    result = serve_stats(tag, serve, bad, run, launches)
    n_attn, n_ssm = arch.layer_kinds().count("attn"), arch.layer_kinds().count("ssm")
    n_pre, n_dec = result["prefill_calls"], result["decode_calls"]
    want = {"ssd_scan": n_ssm * n_pre, "flash_attention": n_attn * n_pre,
            "decode_attention": n_attn * n_dec}
    counts = {k: launches[k] for k in kernel_counters()}
    if n_pre != len(prompts) or not n_dec or counts != {k: want.get(k, 0) for k in counts}:
        fail(f"{tag}: launches {counts} in {n_pre} prefill and {n_dec} decode calls, "
             f"expected {want}")
    wgmma_only(launches, tag, *want)
    dropped_share(tag, launches, result)
    result["prompt_lens"] = list(SERVE_LENS)
    report["jamba_serve" + ("" if graphed else "_eager")] = result
    return launches, serve


def jamba_phase(report: dict) -> dict:
    """(c) the jamba serve eager, then graphed on the same weights (moe_probes
    on for both, so that both hold the markers and counters): equal tokens
    and launches, nothing captured after warmup; a profiled burst of the
    graphed serve split by kernel group (moe_profile).  Returns the graphed
    serve's launches."""
    with moe_probes():
        _, serve = jamba_serve_phase(report, graphed=False)
        params = serve.engine.pairs[0].lane.params
        del serve
        release()
        launches, serve = jamba_serve_phase(report, params)
        del params
        same_as_eager(report, "jamba_serve")
        moe_profile(serve, report, "jamba_profile", PROFILE_LENS, seed=18)
        del serve
        release()
    return launches


def trace_cost_phase(params, report: dict) -> None:
    """The dense graphed serve with StreamTrace off and on, on the same
    weights and trace: the same tokens, kernel launches and captures after
    warmup (every emit is host bookkeeping outside the captured steps); then
    host_split's bursts on the two serves in turns (off, on, on, off, twice)
    for the bookkeeping ms a step of each."""
    serves, out = {}, {}
    for mode in ("off", "on"):
        serves[mode] = serve_phase(report, params, True, trace=mode)
    off, on = report["serve_trace_off"], report["serve_trace_on"]
    if on["tokens"] != off["tokens"] or serves["on"][0] != serves["off"][0]:
        fail("trace cost: trace='on' changed the tokens or the kernel launches")
    if on["captured_after_warmup"] or off["captured_after_warmup"]:
        fail("trace cost: a graph was captured after warmup")
    for i, mode in enumerate(("off", "on", "on", "off") * 2):
        host_split(serves[mode][1], report, f"serve_trace_{mode}_{i}", PROFILE_LENS)
        out.setdefault(mode, []).append(report["host_split"][f"serve_trace_{mode}_{i}"])
    for mode in ("off", "on"):
        engine = serves[mode][1].engine
        out[mode] = {**{m: sum(r[m] for r in out[mode]) / len(out[mode])
                        for m in ("wall", "dispatch", "device", "bookkeeping")},
                     "bookkeeping_runs": [r["bookkeeping"] for r in out[mode]],
                     "events": len(engine.trace_events()), "dropped": engine.trace.dropped}
    if out["off"]["events"] or not out["on"]["events"] or out["on"]["dropped"]:
        fail(f"trace cost: events off/on {out['off']['events']}/{out['on']['events']}, "
             f"{out['on']['dropped']} dropped")
    del serves
    report["trace_cost"] = out
    print(f"trace cost: tokens and launches equal with trace on ({out['on']['events']} events); "
          + "; ".join(f"trace {m}: {r['wall']:.2f} ms a step = dispatch {r['dispatch']:.2f} + "
                      f"device wait {r['device']:.2f} + bookkeeping {r['bookkeeping']:.3f} (runs "
                      + ", ".join(f"{b:.3f}" for b in r["bookkeeping_runs"]) + ")"
                      for m, r in out.items()))


def sse_stream(addr, prompt, n, drop_after=None):
    """One streaming completion over the gateway: its status, token frames,
    terminal frames, whether ``[DONE]`` ended it, the send time and each
    token frame's arrival (host clock); ``drop_after`` frames, then the
    socket is dropped."""
    from repro_torch.gateway.client import SSEClient, completion_body

    t0 = time.perf_counter()
    out = {"t0": t0, "tokens": [], "times": [], "terminals": [], "rid": None}
    with SSEClient(*addr, "/v1/completions", completion_body(prompt, n), timeout=600) as sse:
        out.update(status=sse.status, retry_after=sse.headers.get("retry-after"))
        for frame in sse.events() if sse.status == 200 else ():
            out["rid"] = frame["id"]
            if "usage" in frame or "error" in frame:
                out["terminals"].append(frame)
            else:
                out["tokens"].append(frame["choices"][0]["token"])
                out["times"].append(time.perf_counter())
            if len(out["tokens"]) == drop_after:
                break
        out["done"] = sse.done
    return out


def wait_for(what: str, cond, timeout: float = 300.0) -> None:
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            fail(f"gateway: timed out waiting for {what}")
        time.sleep(0.01)


def gateway_phase(params, report: dict) -> None:
    """The serving front door on the card: ``StreamServe(ServeConfig(...))``
    at full width (qwen3-1.7b, 2 pairs x 8 slots, max_len 512, trace on,
    ``gateway_max_pending`` 24) on the dense serve's weights, warmed up (every
    graph captured), then ``GatewayThread`` on port 0.  One prompt served in
    process, then the same prompt over the idle gateway: equal tokens.  Wave
    1: 24 concurrent SSE streams of 32 tokens, the prompts the port's
    ``sample_mixed`` trace clipped to max_len: each stream's tokens equal its
    request's output, its terminal ``usage`` agrees, ``[DONE]`` comes last;
    client TTFT/TPOT, completions/s, tokens/s and wall ms per engine step.
    Wave 2: 40 streams at once: 429s with Retry-After, one stream dropped
    after 4 frames is cancelled, ``/admin/fail_worker/1`` mid-wave leaves
    every client one terminal frame, a flight dump and pair 1 down.  After
    both: no graph captured during HTTP serving, ``/metrics`` against the
    monitor, a submit and one terminal event per request in the trace, every
    slot and page free.  The main thread makes no CUDA call while the
    gateway serves: every engine read goes through ``GatewayThread.call``."""
    import concurrent.futures
    import re

    import numpy as np

    from repro_torch.api import ServeConfig
    from repro_torch.data.workloads import sample_mixed
    from repro_torch.gateway import GatewayThread
    from repro_torch.gateway.client import http_request
    from repro_torch.obs.trace import EV_SUBMIT, TERMINAL_EVENTS

    out_dir = ROOT / "chiprun_out" / "gateway"
    trace_dir = out_dir / "flight"
    cfg = ServeConfig(reduced=False, max_new_tokens=32, trace="on", trace_dir=str(trace_dir),
                      gateway_max_pending=24)
    serve = served(cfg, True, params=params)
    n_new, clip = 32, cfg.max_len - 32  # the SUM prompts average ~620 tokens
    wave1 = [s.request.prompt[:clip] for s in sample_mixed(6, seed=0, vocab_size=serve.arch.vocab_size)]
    wave2 = [s.request.prompt[:clip] for s in sample_mixed(10, seed=1, vocab_size=serve.arch.vocab_size)]
    want = serve.submit(wave1[0]).result()  # in process, before the gateway starts
    spans, step = [], serve.step

    def timed_step():  # the gateway thread's engine steps, on the host clock
        t = time.perf_counter()
        n = step()
        spans.append((t, time.perf_counter()))
        return n

    serve.step = timed_step
    thread = GatewayThread(serve, port=0)
    addr = thread.start(timeout=120)
    on_loop = lambda fn: thread.call(fn, timeout=300)  # noqa: E731
    graphs_before = on_loop(lambda: captured(serve))
    result = {"graphs_at_start": graphs_before, "warmup_s": serve.warm["warmup_s"]}
    try:
        idle = sse_stream(addr, wave1[0], n_new)
        if idle["tokens"] != want:
            fail("gateway: the idle gateway's SSE tokens differ from the in-process tokens")

        zero_counts()
        steps0 = on_loop(lambda: serve.engine._now)
        first = on_loop(lambda: len(spans))
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(wave1)) as pool:
            runs = list(pool.map(lambda p: sse_stream(addr, p, n_new), wave1))
        wall = time.perf_counter() - t0
        steps = on_loop(lambda: serve.engine._now) - steps0
        ticks = on_loop(lambda: spans[first:])
        launches = read_counts()
        recs = on_loop(lambda: {r.request_id: r for r in serve.monitor.completed})
        for prompt, r in zip(wave1, runs, strict=True):
            if r["status"] != 200 or not r["done"] or len(r["terminals"]) != 1:
                fail(f"gateway wave 1: status {r['status']}, [DONE] {r['done']}, "
                     f"{len(r['terminals'])} terminal frames")
            term = r["terminals"][0]
            if (r["tokens"] != term["choices"][0]["token_ids"] or len(r["tokens"]) != n_new
                    or recs[r["rid"]].generated != n_new):
                fail(f"gateway wave 1: {r['rid']}'s frames differ from its request's output")
            if term["usage"] != {"prompt_tokens": len(prompt), "completion_tokens": n_new,
                                 "total_tokens": len(prompt) + n_new}:
                fail(f"gateway wave 1: {r['rid']}'s usage {term['usage']} disagrees")
        for name in ("decode_attention", "flash_attention"):
            if not launches[name]:
                fail(f"gateway wave 1: no {name} launch")
        wgmma_only(launches, "gateway", "flash_attention", "decode_attention")
        ttft = [r["times"][0] - r["t0"] for r in runs]
        tpot = [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) for r in runs]
        result["wave1"] = {
            "streams": len(runs), "wall_s": wall, "engine_steps": steps,
            "ms_per_step": wall / steps * 1e3, "completions_per_s": len(runs) / wall,
            # between the first step's start and the last one's end: the engine's
            # steps, and the loop's time between them (yield, token pump, SSE writes)
            "step_ms": sum(b - a for a, b in ticks) / len(ticks) * 1e3,
            "loop_ms_per_step": ((ticks[-1][1] - ticks[0][0]) - sum(b - a for a, b in ticks))
            / len(ticks) * 1e3,
            "tokens_per_s": len(runs) * n_new / wall, "launches": launches,
            **{f"ttft_s_p{q}": float(np.percentile(ttft, q)) for q in (50, 99)},
            **{f"tpot_ms_p{q}": float(np.percentile(tpot, q)) * 1e3 for q in (50, 99)}}

        with concurrent.futures.ThreadPoolExecutor(len(wave2)) as pool:
            dropped = pool.submit(sse_stream, addr, wave2[0], n_new, 4)
            wait_for("the dropped stream's admission", lambda: on_loop(lambda: serve.pending))
            rest = [pool.submit(sse_stream, addr, p, n_new) for p in wave2[1:]]
            now = on_loop(lambda: serve.engine._now)
            wait_for("wave 2 to run", lambda: on_loop(lambda: serve.engine._now) >= now + 3)
            status, _, body = http_request(*addr, "POST", "/admin/fail_worker/1", timeout=300)
            if status != 200:
                fail(f"gateway: /admin/fail_worker/1 answered {status}")
            rerouted = json.loads(body)["rerouted"]
            dropped, rest = dropped.result(timeout=600), [f.result(timeout=600) for f in rest]
        refused = [r for r in rest if r["status"] == 429]
        if not refused or any(r["retry_after"] != "1" for r in refused):
            fail(f"gateway wave 2: {len(refused)} 429s, Retry-After "
                 f"{sorted({str(r['retry_after']) for r in refused})}")
        served_ = [r for r in rest if r["status"] == 200]
        if len(served_) + len(refused) != len(rest):
            fail(f"gateway wave 2: statuses {sorted({r['status'] for r in rest})}")
        if any(len(r["terminals"]) != 1 or not r["done"] for r in served_):
            fail("gateway wave 2: a client did not get exactly one terminal frame and [DONE]")
        wait_for("the dropped stream's cancel",
                 lambda: on_loop(lambda: any(r.request_id == dropped["rid"] and r.cancelled
                                             for r in serve.monitor.completed)))
        wait_for("the engine to drain", lambda: on_loop(lambda: serve.pending) == 0)
        dumps = sorted(p.name for p in trace_dir.glob("flight_fail_worker_*.json"))
        status, _, body = http_request(*addr, "GET", "/healthz", timeout=300)
        health = [w["healthy"] for w in json.loads(body)["workers"]]
        if status != 200 or health != [True, False] or not dumps:
            fail(f"gateway wave 2: /healthz {status} {health}, flight dumps {dumps}")
        result["wave2"] = {"streams": len(wave2), "refused_429": len(refused),
                           "served": len(served_) + 1, "rerouted": rerouted,
                           "flight_dumps": dumps}

        status, _, body = http_request(*addr, "GET", "/metrics", timeout=300)
        text = body.decode()
        sample = re.compile(r"^[A-Za-z_:][A-Za-z0-9_:]*(\{[^}]*\})? ([-+]?[0-9.e+-]+|[-+]?Inf)$")
        bad = [ln for ln in text.splitlines() if ln and not ln.startswith("#")
               and not sample.match(ln)]
        recs = on_loop(lambda: list(serve.monitor.completed))
        counts = {"finished": sum(not r.cancelled and not r.slo_infeasible for r in recs),
                  "cancelled": sum(r.cancelled for r in recs),
                  "shed": sum(r.slo_infeasible for r in recs)}
        want_lines = [f'streamserve_requests_total{{state="{k}"}} {v}' for k, v in counts.items()]
        want_lines.append(f"streamserve_tokens_generated_total {sum(r.generated for r in recs)}")
        if status != 200 or bad or any(ln not in text.splitlines() for ln in want_lines):
            fail(f"gateway /metrics: status {status}, unparsed {bad[:3]}, expected {want_lines}")
        graphs_after = on_loop(lambda: captured(serve))
        if graphs_after != graphs_before:
            fail(f"gateway: {graphs_after - graphs_before} graphs captured during HTTP serving")
        free = on_loop(lambda: [(len(p.free_slots()), p.kv.free_blocks) for p in
                                serve.engine.pairs])
        if free != [(cfg.max_batch, cfg.kv_blocks)] * cfg.n_pairs:
            fail(f"gateway: slots and pages not all free after the waves: {free}")
        doc = on_loop(lambda: serve.export_chrome_trace(str(out_dir / "gateway_trace.json")))
        events = on_loop(serve.trace_events)
        dropped_events = on_loop(lambda: serve.engine.trace.dropped)
        json.loads((out_dir / "gateway_trace.json").read_text())
        for r in recs:
            mine = [e[3] for e in events if e[4] == r.request_id]
            if EV_SUBMIT not in mine or sum(e in TERMINAL_EVENTS for e in mine) != 1:
                fail(f"gateway trace: {r.request_id} events {mine}")
        result.update(requests=len(recs), states=counts, trace_events=len(events),
                      trace_dropped=dropped_events, chrome_events=len(doc["traceEvents"]),
                      graphs_during_http=graphs_after - graphs_before)
    finally:
        thread.stop(timeout=120)
    w1 = result["wave1"]
    dense = report["serve"]["step_s_mean"] * 1e3
    result["in_process_ms_per_step"] = dense
    report["gateway"] = result
    print(f"gateway wave 1: {w1['streams']} SSE streams of {n_new} tokens in {w1['wall_s']:.3f} s "
          f"({w1['completions_per_s']:.2f} completions/s, {w1['tokens_per_s']:.1f} tokens/s), "
          f"TTFT p50 {w1['ttft_s_p50']:.4f} s p99 {w1['ttft_s_p99']:.4f} s, TPOT p50 "
          f"{w1['tpot_ms_p50']:.2f} ms p99 {w1['tpot_ms_p99']:.2f} ms; launches {w1['launches']}")
    print(f"gateway: {w1['ms_per_step']:.2f} ms per engine step over HTTP "
          f"({w1['engine_steps']:g} steps) against {dense:.2f} in process (graphed dense serve); "
          f"the gateway's steps {w1['step_ms']:.2f} ms each, its loop {w1['loop_ms_per_step']:.2f} "
          f"ms between two")
    print(f"gateway wave 2: {len(wave2)} streams, {result['wave2']['refused_429']} refused with 429, "
          f"pair 1 failed mid-wave ({result['wave2']['rerouted']} rerouted), flight dump "
          f"{result['wave2']['flight_dumps']}; {result['requests']} requests, states "
          f"{result['states']}, {result['trace_events']} trace events, "
          f"{result['graphs_during_http']} graphs captured during HTTP serving")


def cli_phase(report: dict) -> None:
    """The serve CLI at full width on the card, as a user runs it: warmup,
    8 requests, one cancelled at step 3, pair 1 killed at step 5, a Chrome
    trace written.  It must exit 0, print its ``completed`` line and write a
    trace that loads."""
    import os

    out = ROOT / "chiprun_out" / "cli"
    out.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--no-reduced", "--warmup",
           "--requests", "8", "--cancel-one", "--fail-worker", "1", "--trace-out",
           str(out / "t.json")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    (out / "stdout.txt").write_text(proc.stdout + proc.stderr)
    completed = [ln for ln in proc.stdout.splitlines() if ln.startswith("completed ")]
    if proc.returncode != 0 or not completed:
        fail(f"cli: exit {proc.returncode}; {(proc.stdout + proc.stderr)[-2000:]}")
    doc = json.loads((out / "t.json").read_text())
    report["cli"] = {"wall_s": wall, "completed": completed[0],
                     "chrome_events": len(doc["traceEvents"])}
    print(f"cli: exit 0 in {wall:.1f} s, '{completed[0]}', trace of "
          f"{len(doc['traceEvents'])} Chrome events")


# ------------------------------------------------------- training (qwen3-1.7b)

# (B, S, H, K, D, dtype, window): the training shape in both dtypes, a ragged
# last tile, one query head a KV head (llama2-7b), a window, head_dim 64, and
# a ragged length under a window that is not a multiple of 64 at G = 4, D = 64;
# qwen3-moe-30b-a3b's training shape (G = 8) in both dtypes
BWD_CASES = [(4, 2048, 16, 8, 128, "bfloat16", None), (4, 2048, 16, 8, 128, "float32", None),
             (4, 2048, 32, 4, 128, "bfloat16", None), (4, 2048, 32, 4, 128, "float32", None),
             (2, 1000, 16, 8, 128, "bfloat16", None), (1, 2048, 32, 32, 128, "bfloat16", None),
             (2, 2048, 16, 8, 128, "bfloat16", 512), (2, 1024, 16, 8, 64, "bfloat16", None),
             (1, 1000, 8, 2, 64, "bfloat16", 130)]
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# row_err's limit: each gradient row's largest error over that row's RMS
BWD_ROW_TOL = {"bfloat16": 0.1, "float32": 1e-2}
TRAIN_STEPS, TRAIN_TOKENS = 8, (4, 2048)  # the full-width runs: steps, batch x sequence
# the training runs: arch -> layers kept (None: full depth).  qwen3-moe at 4
# of 48 layers: each layer is 0.62B parameters, 7.5 GB with AdamW's moments,
# so all 48 would need ~366 GB.  mamba2-2.7b at 32 of 64 layers, for the
# call's time limit (K4's shapes do not change with depth; PERF.md keeps its
# full-depth run).  seamless-m4t-large-v2 (1.63B parameters, untied) and
# internvl2-1b (0.49B) at full depth
TRAIN_RUNS = {"qwen3-1.7b": None, "mamba2-2.7b": 32, "qwen3-moe-30b-a3b": 4,
              "seamless-m4t-large-v2": None, "internvl2-1b": None}
# expert_marks()' marker kernels and the part of a training step that
# follows each: the expert products' forward (flip ... roll) and backward
# (tril ... triu)
TRAIN_MARKERS = ((r"flip_kernel", "expert products"), (r"roll_cuda_kernel", None),
                 (r"triu_tril_kernel<[^,]+, [^,]+, false", "expert products"),
                 (r"triu_tril_kernel<[^,]+, [^,]+, true", None))


def plain_mask(q, k, causal, window):
    """(Sq, Sk) visibility of keys to queries, as ``ref`` masks."""
    import torch

    from repro_torch.kernels import ref

    i, j = (torch.arange(t.shape[1], device=q.device) for t in (q, k))
    return ref._mask(i[:, None], j[None], causal, window)


def plain_lse(q, k, window=None, causal=True):
    """Each row's log-sum-exp of the plain version's masked scaled scores,
    (B, H, Sq) float32 (NEG_INF where masked, as ``ref`` masks)."""
    import torch

    from repro_torch.kernels import ref

    D = q.shape[3]
    G = q.shape[2] // k.shape[2]
    kk = k.float().repeat_interleave(G, 2)
    mask = plain_mask(q, k, causal, window)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * D ** -0.5, kk)
    return torch.logsumexp(torch.where(mask, s, ref.NEG_INF), -1)


def row_err(got, want) -> float:
    """The largest error in a gradient row (one position of one head) over
    that row's RMS in ``want``.  Under a causal mask a row's size falls with
    its position (~1/sqrt(row) on random inputs), so an absolute tolerance
    that passes the large early rows cannot see an error in the small late
    ones; this reading weighs every row alike.  A row whose RMS is under 1%
    of the tensor's is held to that 1% (dq of the first query is 0)."""
    want = want.float()
    diff = (got.float() - want).abs().amax(-1)
    rms = want.pow(2).mean(-1).sqrt()
    return float((diff / rms.clamp_min(1e-2 * float(want.pow(2).mean().sqrt()))).max())


def plain_bwd(q, k, v, out, dout, window=None, causal=True):
    """The backward's own arithmetic, plainly, in fp32 on the kernel's
    inputs: P recomputed from the masked scores, delta = rowsum(dout
    * out) from the output it is given (bf16 in training, as the kernel
    reads it), dS = P (dP - delta); (dq, dk, dv) in q's dtype.  row_err
    reads against this, not against the autograd of the plain forward,
    whose delta comes from the output before its rounding: in a row whose
    softmax sits on one key, that rounding alone moves dq by ~0.13 of the
    row's RMS (SDPA's backward as much as the kernel)."""
    import torch

    D = q.shape[3]
    G = q.shape[2] // k.shape[2]
    qf, of, df = q.float(), out.float(), dout.float()
    kf, vf = (t.float().repeat_interleave(G, 2) for t in (k, v))
    mask = plain_mask(q, k, causal, window)
    p = torch.einsum("bqhd,bkhd->bhqk", qf * D ** -0.5, kf).masked_fill(~mask, float("-inf"))
    p = p.softmax(-1)
    delta = (df * of).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", df, vf) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * D ** -0.5
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).unflatten(2, (-1, G)).sum(3) * D ** -0.5
    dv = torch.einsum("bhqk,bqhd->bkhd", p, df).unflatten(2, (-1, G)).sum(3)
    return [t.to(q.dtype) for t in (dq, dk, dv)]


def row_readings(q, k, v, out, dout, window, plain, got, want, causal=True) -> dict:
    """Beside row_err's limit, at one case: its control, the plain dk and dv
    with the last 64-row query tile of head 0 left out (its dout zeroed),
    read against the full ones as the kernel's are, over every key row and
    over the first half of the keys alone, for which (causal) that tile is
    one far tile of 16 or more; and the kernel's and (no window) SDPA's
    backward read against the plain forward's autograd.  Fails unless the
    control's whole reading exceeds BWD_ROW_TOL: the check must see a
    missing tile."""
    import torch

    cut = dout.clone()
    cut[:, -64:, 0] = 0
    drop = plain_bwd(q, k, v, out, cut, window, causal)
    half = k.shape[1] // 2
    r = {f"control {name}{part}": row_err(a[:, rows], b[:, rows])
         for name, a, b in (("dk", drop[1], plain[1]), ("dv", drop[2], plain[2]))
         for part, rows in (("", slice(None)), (" first half", slice(0, half)))}
    r.update({f"kernel vs autograd {n}": row_err(a, b)
              for n, a, b in zip(("dq", "dk", "dv"), got, want, strict=True)})
    if window is None:
        th = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
        lib = torch.autograd.grad(sdpa(*th, is_causal=causal), th,
                                  dout.transpose(1, 2).contiguous())
        r.update({f"sdpa vs autograd {n}": row_err(a.transpose(1, 2), b)
                  for n, a, b in zip(("dq", "dk", "dv"), lib, want, strict=True)})
    tol = BWD_ROW_TOL[str(q.dtype).split(".")[-1]]
    print("K2 backward row readings (limit " + f"{tol}): " + ", ".join(
        f"{k} {x:.4g}" for k, x in r.items()))
    if min(r["control dk"], r["control dv"]) <= tol:
        fail("K2 backward: the row check cannot tell a dropped query tile")
    return r


def bwd_cost(q, k, causal=True):
    """(bytes, ops) of the backward: q, k, v, out, dout and lse read once,
    dq, dk, dv written once; five products over the visible pairs."""
    nbytes, ops = flash_cost(q, k, causal)
    return nbytes * 2 + q.shape[0] * q.shape[2] * q.shape[1] * 4, ops * 5 // 2


def bwd_timing(q, k, v, dout, causal=True) -> tuple:
    """At one bf16 shape: two backward calls bit for bit; then the backward,
    the plain version's backward and SDPA's backward timed (the forwards
    outside the timed region), and K2's forward with lse and without it
    beside the plain forward and SDPA's; returns the (backward, forward)
    timing rows."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda

    B, Sq, H, D = q.shape
    Sk, K = k.shape[1:3]
    shape = f"B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} {'' if causal else 'not '}causal bf16"
    o, lse = flash_attention_cuda(q, k, v, causal=causal, lse=True)
    same_bits(f"K2 backward at {shape}",
              lambda: flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal=causal))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_o = ref.flash_attention(*leaves, causal=causal)
    th = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    sdpa_o, dout_h = sdpa(*th, is_causal=causal), dout.transpose(1, 2).contiguous()
    nbytes, ops = bwd_cost(q, k, causal)
    bwd = {"shape": shape,
           "ms": timed(lambda i: flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal=causal), 20),
           "plain_ms": timed(lambda i: torch.autograd.grad(plain_o, leaves, dout,
                                                           retain_graph=True), 3),
           "library_ms": timed(lambda i: torch.autograd.grad(sdpa_o, th, dout_h,
                                                             retain_graph=True), 20),
           "bound": bound_ms(nbytes, ops, "bfloat16")}
    del plain_o, sdpa_o
    nbytes, ops = flash_cost(q, k, causal)
    fwd = {"shape": shape,
           "ms": timed(lambda i: flash_attention_cuda(q, k, v, causal=causal, lse=True), 20),
           "ms_no_lse": timed(lambda i: flash_attention_cuda(q, k, v, causal=causal), 20),
           "plain_ms": timed(lambda i: ref.flash_attention(q, k, v, causal=causal), 3),
           "library_ms": timed(lambda i: sdpa(*th, is_causal=causal), 20),
           "bound": bound_ms(nbytes + B * H * Sq * 4, ops, "bfloat16")}
    return bwd, fwd


def show_bwd_timing(rows: dict) -> None:
    for key, r in rows.items():
        show_timing("flash_attention_bwd" if key.startswith("bwd") else "flash_attention (lse)", r)
        if "ms_no_lse" in r:
            print(f"flash_attention without lse at the same shape: {r['ms_no_lse']:.4f} ms")


def train_kernel_phase(report: dict, cases=BWD_CASES, timings=(("", 16, 8), (" g8", 32, 4)),
                       key: str = "train_kernels", seed: int = 11) -> dict:
    """(a) K2's backward against the plain version's autograd on the card
    (dq, dk, dv elementwise within tol + tol*|b|: 1e-4 fp32, 2e-2 bf16),
    and each gradient row against plain_bwd within BWD_ROW_TOL of its RMS
    (row_err; row_readings at the first case), at the training shape in
    both dtypes, a ragged length, G = 1, a window, head_dim 64 and a ragged
    G = 4 window at head_dim 64; every bf16 call on the tensor-core passes,
    every fp32 call on the CUDA-core ones; the forward's lse against the
    plain scores' logsumexp; then at the training
    shape (bf16; ``timings``: key suffix, H, K) two backward calls bit for
    bit, and the backward, the plain version's backward and SDPA's backward
    timed (forwards outside the timed region), and K2's forward with and
    without lse beside the plain forward and SDPA's.  ``cases`` and
    ``timings`` default to qwen3-1.7b's and qwen3-moe-30b-a3b's heads."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    errs, out = {"dq": 0.0, "dk": 0.0, "dv": 0.0, "lse": 0.0, "out": 0.0}, {}
    rows = {dt: {"dq": 0.0, "dk": 0.0, "dv": 0.0} for dt in BWD_TOL}
    readings = None
    for B, S, H, K, D, dt, window in cases:
        tag = f"K2 backward B={B} S={S} H={H} K={K} D={D} {dt} window={window}"
        q, k, v, dout = (torch.randn(B, S, n, D, generator=g, device="cuda").to(getattr(torch, dt))
                         for n in (H, K, K, H))
        o, lse = flash_attention_cuda(q, k, v, window=window, lse=True)
        errs["out"] = max(errs["out"], check(f"{tag}: out", o, flash_attention_cuda(
            q, k, v, window=window), dt, {dt: 0.0}))  # serving's call (lse null): the same bits
        errs["lse"] = max(errs["lse"], check(f"{tag}: lse", lse, plain_lse(q, k, window), dt,
                                             BWD_TOL))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(ref.flash_attention(*leaves, window=window), leaves, dout)
        before = flash_attention_bwd_cuda.wgmma_launches
        got = flash_attention_bwd_cuda(q, k, v, o, dout, lse, window=window)
        if flash_attention_bwd_cuda.wgmma_launches - before != (dt == "bfloat16"):
            fail(f"{tag}: the call did not take the {dt} backward's kernels")
        plain, here = plain_bwd(q, k, v, o, dout, window), {}
        for name, a, b, c in zip(("dq", "dk", "dv"), got, want, plain, strict=True):
            errs[name] = max(errs[name], check(f"{tag}: {name}", a, b, dt, BWD_TOL))
            here[name] = row_err(a, c)
            rows[dt][name] = max(rows[dt][name], here[name])
        print(f"{tag}: dq/dk/dv match the plain version's autograd; row errors against "
              "plain_bwd " + ", ".join(f"{n} {x:.4g}" for n, x in here.items()))
        if max(here.values()) > BWD_ROW_TOL[dt]:
            fail(f"{tag}: a gradient row differs by more than {BWD_ROW_TOL[dt]} of its RMS")
        if readings is None:
            readings = row_readings(q, k, v, o, dout, window, plain, got, want)
        del want, leaves, got, plain
    torch.cuda.synchronize()
    # timing at the training shapes, bf16 (inputs of 134 MB and more: past the
    # L2 by themselves): qwen3-1.7b's (G = 2) and qwen3-moe-30b-a3b's (G = 8)
    for suffix, H, K in timings:
        q, k, v, dout = (torch.randn(4, 2048, n, 128, generator=g, device="cuda")
                         .to(torch.bfloat16) for n in (H, K, K, H))
        out["bwd" + suffix], out["fwd" + suffix] = bwd_timing(q, k, v, dout)
        out["bwd" + suffix]["max_abs_err"] = max(errs["dq"], errs["dk"], errs["dv"])
        out["fwd" + suffix]["max_abs_err"] = max(errs["out"], errs["lse"])
        del q, k, v, dout
    report[key] = {"errs": errs, "row_errs": rows, "row_readings": readings,
                               **{k: dict(v, bound=list(v["bound"])) for k, v in out.items()}}
    show_bwd_timing(out)
    return out


# K2's backward as the encoder-decoder and the vision-prefix model train it:
# name -> (B, Sq, Sk, H, K, D, causal), each in bf16 and fp32, then timed in
# bf16: seamless's cross attention over launch.train's 16 frames and over its
# frontend's 1,024, a ragged 1000 x 300, its encoder over 1,024 frames and
# over launch.train's 16, its decoder's self-attention, and internvl2's
# causal attention over 256 patches + 2,048 tokens at G = 7
ENCDEC_BWD = {"seamless cross": (4, 2048, 16, 16, 16, 64, False),
              "seamless cross 1024": (4, 2048, 1024, 16, 16, 64, False),
              "ragged cross": (2, 1000, 300, 16, 16, 64, False),
              "seamless encoder 1024": (4, 1024, 1024, 16, 16, 64, False),
              "seamless encoder": (4, 16, 16, 16, 16, 64, False),
              "seamless decoder": (4, 2048, 2048, 16, 16, 64, True),
              "internvl2": (4, 2304, 2304, 14, 2, 64, True)}
TRAIN_FRAMES = 16  # launch.train's zero frames a row (the reference's make_batch)


def tol_ratio(got, want, tol: float) -> float:
    """The largest |got - want| / (tol + tol |want|): check() passes at <= 1."""
    d = (got.float() - want.float()).abs()
    return float((d / (tol + tol * want.float().abs())).max())


def encdec_bwd_phase(report: dict) -> dict:
    """K2's forward (with lse) and backward at ENCDEC_BWD's shapes: queries
    and keys of their own lengths without a mask, G = 1 at head_dim 64 and
    G = 7 under a causal mask.  In bf16 and fp32: the output against the
    plain version, lse against the plain scores' logsumexp, each gradient
    row against plain_bwd within BWD_ROW_TOL of its RMS, every bf16 call on
    the tensor-core passes and every fp32 call on the CUDA-core ones; dq,
    dk, dv in fp32 against the plain version's autograd within BWD_TOL (tol
    + tol*|b|); in bf16 against the plain version's autograd on the inputs
    in fp32 (the oracle), by tol_ratio at BWD_TOL, no further from it than
    1 or than the plain version's own bf16 autograd (SDPA's backward read
    beside them): at 16 keys each dk and dv row sums 2,048 queries, and no
    bf16 backward holds every small entry of a large row to 2e-2; at the
    ragged case the drop-a-tile control (row_readings); then in bf16 each
    shape bit for bit on repeat and timed (bwd_timing)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda

    g = torch.Generator(device="cuda").manual_seed(28)
    out, lines, readings = {}, [], None
    for name, (B, Sq, Sk, H, K, D, causal) in ENCDEC_BWD.items():
        for dt in BWD_TOL:
            t0 = time.perf_counter()
            tag = (f"K2 backward ({name}) B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} "
                   f"{'' if causal else 'not '}causal {dt}")
            q, k, v, dout = (torch.randn(B, n, h, D, generator=g, device="cuda")
                             .to(getattr(torch, dt)) for n, h in ((Sq, H), (Sk, K), (Sk, K), (Sq, H)))
            o, lse = flash_attention_cuda(q, k, v, causal=causal, lse=True)
            errs = {"out": check(f"{tag}: out", o, ref.flash_attention(q, k, v, causal=causal), dt),
                    "lse": check(f"{tag}: lse", lse, plain_lse(q, k, causal=causal), dt, BWD_TOL)}
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(ref.flash_attention(*leaves, causal=causal), leaves, dout)
            before = flash_attention_bwd_cuda.wgmma_launches
            got = flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal=causal)
            if flash_attention_bwd_cuda.wgmma_launches - before != (dt == "bfloat16"):
                fail(f"{tag}: the call did not take the {dt} backward's kernels")
            plain, rows, ratios = plain_bwd(q, k, v, o, dout, causal=causal), {}, {}
            if dt == "bfloat16":
                l32 = [t.float().requires_grad_() for t in (q, k, v)]
                oracle = torch.autograd.grad(ref.flash_attention(*l32, causal=causal), l32,
                                             dout.float())
                th = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
                lib = [t.transpose(1, 2) for t in torch.autograd.grad(
                    sdpa(*th, is_causal=causal), th, dout.transpose(1, 2).contiguous())]
            for i, (n, a, c) in enumerate(zip(("dq", "dk", "dv"), got, plain, strict=True)):
                rows[n] = row_err(a, c)
                if dt == "float32":
                    errs[n] = check(f"{tag}: {n}", a, want[i], dt, BWD_TOL)
                    continue
                errs[n] = max_err(a, oracle[i])
                ratios[n] = [tol_ratio(x[i], oracle[i], BWD_TOL[dt]) for x in (got, want, lib)]
                if not torch.isfinite(a).all() or ratios[n][0] > max(1.0, ratios[n][1]):
                    fail(f"{tag}: {n} is {ratios[n][0]:.3g} x tol from the fp32 oracle, the "
                         f"plain version's bf16 autograd {ratios[n][1]:.3g} x")
            lines.append(f"{tag}: max_abs_err " + ", ".join(f"{n} {x:.3g}" for n, x in errs.items())
                         + "; row errors " + ", ".join(f"{n} {x:.4g}" for n, x in rows.items())
                         + "".join(f"; {n} from the fp32 oracle in tol: kernel {a:.3g}, plain "
                                   f"{b:.3g}, SDPA {c:.3g}" for n, (a, b, c) in ratios.items())
                         + f" ({time.perf_counter() - t0:.1f} s)")
            print(lines[-1])
            if max(rows.values()) > BWD_ROW_TOL[dt]:
                fail(f"{tag}: a gradient row differs by more than {BWD_ROW_TOL[dt]} of its RMS")
            if name == "ragged cross" and dt == "bfloat16":
                readings = row_readings(q, k, v, o, dout, None, plain, got, want, causal)
            del want, leaves, got, plain, o, lse
            if dt == "bfloat16":
                del l32, oracle, th, lib
            if dt == "bfloat16":
                bwd, fwd = bwd_timing(q, k, v, dout, causal)
                out["bwd " + name] = dict(bwd, max_abs_err=max(errs[n] for n in ("dq", "dk", "dv")))
                out["fwd " + name] = dict(fwd, max_abs_err=max(errs["out"], errs["lse"]))
            del q, k, v, dout
    report["encdec_train_kernels"] = {"checks": lines, "row_readings": readings,
                                      **{k: dict(v, bound=list(v["bound"])) for k, v in out.items()}}
    show_bwd_timing(out)
    return out


def train_model_phase(report: dict, arch: str = "qwen3-1.7b") -> None:
    """(b) 2 full-width layers of ``arch`` (an encoder-decoder also 2
    encoder layers), fp32, remat "minimal": the loss (with a MoE model's
    router losses) and every gradient leaf on the card (K2's or K4's
    forward and backward on their CUDA-core kernels; cross attention on K2,
    K1 never) against the same weights on the CPU: the loss within 1e-5
    relative, each leaf within 1e-3 x its max |g|; for MoE first each
    token's chosen experts and its keep mask at capacity, call by call,
    identical.  2 rows of 200 tokens, behind 11 random frames a row (the
    encoder's and cross attention's gradients not zero) or the frontend's
    random patches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.params import tree_items, tree_map

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32",
                              n_encoder_layers=min(get_config(arch).n_encoder_layers, 2))
    gen = torch.Generator().manual_seed(4)
    batch = (encdec_inputs(cfg, 2, 200, gen, "cpu", 11 if cfg.is_encdec else None)
             if cfg.frontend else
             {"tokens": torch.randint(0, cfg.vocab_size, (2, 200), generator=gen, dtype=torch.int32)})
    params = build_model(cfg, "cuda").init(1)
    results = {}
    zero_counts()
    with (routing_recorded() if cfg.moe else contextlib.nullcontext()) as seen:
        for dev, p in (("cuda", params), ("cpu", to_cpu(params))):
            live = tree_map(lambda t: t.detach().requires_grad_(), p)
            leaves = [t for _, t in tree_items(live)]
            loss, _ = build_model(cfg, dev).loss_fn(live, {k: t.to(dev) for k, t in batch.items()})
            results[dev] = (float(loss.detach()),
                            [t.cpu() for t in torch.autograd.grad(loss, leaves)])
            if dev == "cuda":
                launches = read_counts()
    tag = f"train model check {arch}"
    if cfg.moe:
        same_routing(tag, cfg, seen, report)
    names = [k for k, _ in tree_items(params)]
    (lg, gg), (lc, gc) = results["cuda"], results["cpu"]
    worst = max((max_err(a, b) / max(float(b.abs().max()), 1e-30), n)
                for n, a, b in zip(names, gg, gc, strict=True))
    print(f"{tag} (2 full-width layers, fp32, card vs CPU): loss {lg:.6f} / {lc:.6f}; worst "
          f"leaf {worst[1]} at {worst[0]:.3g} x its max |g|; launches {launches}")
    want = bwd_launches(cfg)
    for bwd in (k for k, n in want.items() if n):
        for name in (bwd.removesuffix("_bwd"), bwd):
            no_wgmma(launches, name, tag)
    if any(launches[k] != n for k, n in want.items()) or launches["decode_attention"]:
        fail(f"{tag}: launches {launches}, expected {want} and no K1")
    if abs(lg - lc) > 1e-5 * abs(lc) or worst[0] > 1e-3:
        fail(f"{tag}: loss {lg} vs {lc}, gradient {worst}")
    report["train_model_check" + ("" if arch == "qwen3-1.7b" else f"_{arch}")] = {
        "loss": [lg, lc], "worst_leaf": list(worst), "launches": launches}


def bwd_launches(cfg) -> dict:
    """K2's and K4's backward launches a training step: K2's one an attention
    layer (an encoder-decoder's also one a decoder layer's cross attention
    and one an encoder layer), K4's one a Mamba2 layer."""
    kinds = cfg.layer_kinds()
    return {"flash_attention_bwd": kinds.count("attn") * (1 + cfg.is_encdec)
            + cfg.n_encoder_layers, "ssd_scan_bwd": kinds.count("ssm")}


TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")


def train_flops(cfg, B: int, S: int) -> int:
    """Model FLOPs of a training step over B x S tokens of text: 6 x each
    parameter x the positions it meets, plus three times the forward's
    attention (or SSD) products.  A vision prefix adds its patches to the
    decoder's positions (causal over all of them); an encoder-decoder's
    encoder and its cross attention's K and V projections meet the
    TRAIN_FRAMES frames a row, its cross attention is not causal over
    them."""
    import torch

    meta = functools.partial(torch.empty, device="meta")
    kinds = cfg.layer_kinds()
    ssd = 0
    if "ssm" in kinds:  # the SSD scan's products, each Mamba2 layer
        s = cfg.ssm
        ssd = kinds.count("ssm") * ssd_cost(meta(B, S, s.n_heads(cfg.d_model), s.head_dim),
                                            meta(B, S, s.n_groups, s.d_state), None)[1]
    if cfg.family == "ssm":
        return 6 * cfg.n_active_params() * B * S + 3 * ssd
    d, H, K, D, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, TRAIN_FRAMES
    P = S + (cfg.frontend.n_tokens if cfg.frontend and cfg.frontend.kind == "vision" else 0)

    def attn(sq, sk, causal):
        return flash_cost(meta(B, sq, H, D), meta(B, sk, K, D), causal)[1]

    per_ff = 3 if cfg.mlp_type == "swiglu" else 2
    at_frames = cfg.n_encoder_layers * (2 * d * (H + K) * D + per_ff * d * cfg.d_ff + 2 * d)
    if cfg.is_encdec:  # cross attention's K and V projections
        at_frames += cfg.n_layers * 2 * d * K * D
    ops = kinds.count("attn") * (attn(P, P, True) + (attn(P, F, False) if cfg.is_encdec else 0)) \
        + cfg.n_encoder_layers * attn(F, F, False) + ssd
    return 6 * (at_frames * B * F + (cfg.n_active_params() - at_frames) * B * P) + 3 * ops


@contextlib.contextmanager
def k2_by_shape():
    """Count K2's forward and backward launches by kernel, Sq x Sk and mask
    while on, from each launch's arguments."""
    from collections import Counter

    from repro_torch.kernels import build

    seen, launch = Counter(), build.launch

    def counting(wrapper, name, argtypes, dtype, stream, *args, **kw):
        at = {"flash_attention": 5, "flash_attention_bwd": 10}.get(name)
        if at is not None:
            Sq, Sk, causal = args[at + 1], args[at + 2], args[at + 6]
            seen[f"{name} {Sq}x{Sk} {'' if causal else 'not '}causal"] += 1
        return launch(wrapper, name, argtypes, dtype, stream, *args, **kw)

    build.launch = counting
    try:
        yield seen
    finally:
        build.launch = launch


@contextlib.contextmanager
def train_probes(times: dict):
    """Time each train step (synchronised on both sides) and each checkpoint
    save of ``launch.train``, and keep each step's metrics; profile the step
    listed in ``times["profile"]`` (CUDA activity only); with
    ``times["no_saves"]``, skip the saves (the full-width family runs: a
    save of their 27-31 GB would take most of their time, and the qwen3 run
    and the restart check hold the checkpoint path).  Each step's zero
    frames or patches (the CLI's stub, as the reference's) become seeded
    N(0, 1) values of their shape and dtype, the same every step: at the
    models' depth of 24 the zeros overflow the gradient, in the reference
    too (tests/test_torch_train_encdec.py)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training import checkpoint, train_loop

    make, save = train_loop.make_train_step, checkpoint.CheckpointManager.save
    times.update(step=[], save=[], prof=None, metrics=[])

    def timed_make(*a, **kw):
        init, step = make(*a, **kw)

        def run(params, opt, batch):
            for k in {"frames", "patches"} & set(batch):
                if k not in times:
                    gen = torch.Generator(device="cuda").manual_seed(16)
                    times[k] = torch.randn(batch[k].shape, generator=gen, device="cuda").to(
                        batch[k].dtype)
                batch = dict(batch, **{k: times[k]})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (profile(activities=[ProfilerActivity.CUDA]) if len(times["step"]) ==
                  times.get("profile", -1) else contextlib.nullcontext()) as prof:
                out = step(params, opt, batch)
                torch.cuda.synchronize()
            times["step"].append(time.perf_counter() - t0)
            times["prof"] = prof or times["prof"]
            times["metrics"].append({k: float(v) for k, v in out[2].items()})
            return out
        return init, run

    def timed_save(self, *a, **kw):
        if times.get("no_saves"):
            return None
        t0 = time.perf_counter()
        out = save(self, *a, **kw)
        times["save"].append(time.perf_counter() - t0)
        return out

    train_loop.make_train_step, checkpoint.CheckpointManager.save = timed_make, timed_save
    try:
        yield times
    finally:
        train_loop.make_train_step, checkpoint.CheckpointManager.save = make, save


@contextlib.contextmanager
def expert_marks():
    """Bracket every call of the MoE layer's expert products with marker
    kernels on a 2 x 2 tensor (TRAIN_MARKERS), through an autograd Function
    that launches one in the forward and one in the backward: flip before
    and roll after the forward's products (remat's recomputation too), tril
    before and triu after their backward, so that a profiled training
    step's device timeline tells the expert products from the rest."""
    import torch

    from repro_torch.models import moe

    t = torch.zeros(2, 2, device="cuda")
    ops = {"flip": lambda: torch.flip(t, [0]), "roll": lambda: torch.roll(t, 1, 0),
           "tril": t.tril, "triu": t.triu}

    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, fwd, bwd):
            ops[fwd]()
            ctx.bwd = bwd
            return x.view_as(x)

        @staticmethod
        def backward(ctx, grad):
            ops[ctx.bwd]()
            return grad, None, None

    ffn = moe.expert_ffn
    moe.expert_ffn = lambda p, cfg, buf: Mark.apply(ffn(p, cfg, Mark.apply(buf, "flip", "triu")),
                                                    "roll", "tril")
    try:
        yield
    finally:
        moe.expert_ffn = ffn


def train_phase(report: dict, arch: str = "qwen3-1.7b", cut=None, extra=(), tag="") -> dict:
    """(c) ``launch.train`` at full width, bf16, under the config's optimizer
    and remat policy (AdamW and "minimal"; jamba's adafloor and "full"), 8
    steps of 4 x 2048 tokens, at the depth of TRAIN_RUNS or the fields of
    ``cut`` (the config cut as restart_phase cuts it); an encoder-decoder on the CLI's 16 frames a
    row, a vision-prefix model behind its 256 patches, both seeded random
    (train_probes).  Every loss
    finite (a MoE model's router losses too); a step's launches: K2
    backward one a layer (and one a decoder layer's cross attention) and
    every K2 launch on its wgmma kernels (attention), K4 backward one a
    layer and every K4 launch on its wgmma kernels (Mamba2), the forwards
    counted (remat recomputes them), K2's split by Sq x Sk and mask
    (k2_by_shape); ms a step, tokens/s (of text), MFU against 989 TFLOP/s
    (train_flops), peak memory, the device time of a profiled step split
    into GEMMs, expert products (expert_marks), K4 forward and backward, K2
    forward and backward and the rest.  qwen3-1.7b also saves its two
    checkpoints (step 0 and the end) and times them.  ``extra``: more CLI
    flags (``--compress-grads``), the run's report key and lines marked
    with ``tag``."""
    import dataclasses
    import math
    import re
    import tempfile
    from collections import Counter
    from unittest import mock

    import torch
    from torch.autograd import DeviceType

    from repro_torch import configs
    from repro_torch.launch import train

    cut = cut or ({"n_layers": TRAIN_RUNS[arch]} if TRAIN_RUNS.get(arch) else {})
    cfg = dataclasses.replace(configs.get_config(arch), **cut)
    B, S = TRAIN_TOKENS
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck, \
            train_probes({"profile": 4, "no_saves": arch != "qwen3-1.7b"}) as times, \
            mock.patch.object(configs, "get_config", lambda name: cfg), k2_by_shape() as shapes, \
            (expert_marks() if cfg.moe else contextlib.nullcontext()):
        t0 = time.perf_counter()
        result = train.main(["--arch", arch, "--no-reduced", "--steps", str(TRAIN_STEPS),
                             "--batch", str(B), "--seq-len", str(S), "--ckpt-dir", ck,
                             "--log-every", "1", *extra])
        wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [result["losses"][i] for i in range(TRAIN_STEPS)]
    router = {k: [m[k] for m in times["metrics"]] for k in ("load_balance", "router_z")
              if cfg.moe}
    if not all(map(math.isfinite, losses + sum(router.values(), []))):
        fail(f"train {arch}: a loss is not finite: {losses} {router}")
    per_step = {k: launches[k] / TRAIN_STEPS for k in TRAIN_KERNELS if launches[k]}
    want = {k: n for k, n in bwd_launches(cfg).items() if n}
    if any(per_step.get(k) != n for k, n in want.items()) or set(per_step) != {
            *want, *(k.removesuffix("_bwd") for k in want)} or any(
            launches[f"{k}.wgmma"] != launches[k] for k in per_step):
        fail(f"train {arch}: launches {launches}: expected {want} backward launches a step, "
             "their forwards, and every launch on the tensor-core kernels (K4: "
             "ssd_wgmma_kernel, ssd_bwd_wgmma_kernel; K2: flash_wgmma_kernel, "
             "dkdv_wgmma_kernel and dq_wgmma_kernel)")
    step_s = sorted(times["step"][1:])[len(times["step"][1:]) // 2]  # median, the first warm-up
    flops = train_flops(cfg, B, S)
    events = sorted((e.start_ns(), e.name(), e.duration_ns() / 1e6) for e in
                    times["prof"].profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    groups = ((r"ssd_bwd_(wgmma_)?kernel|ssd_bwd_reduce4?_kernel", "K4 backward"),
              (r"ssd_wgmma_kernel|ssd_kernel", "K4 forward"),
              (r"dkdv_(wgmma_)?kernel|dq_(wgmma_)?kernel|delta_kernel", "K2 backward"),
              (r"flash_wgmma_kernel|flash_kernel", "K2 forward"),
              (r"gemm|nvjet|xmma|cutlass", "GEMMs"))
    parts, kernels, rest, region = Counter(), Counter(), Counter(), None
    for _, name, ms in events:
        mark = next((m for m in TRAIN_MARKERS if re.search(m[0], name)), None) if cfg.moe else None
        if mark is not None:
            region = mark[1]
            parts["markers"] += ms
            continue
        part = next((g for k, g in groups if re.search(k, name.lower())), "rest")
        parts[region or part] += ms
        if part.startswith(("K2", "K4")):
            kernels[re.search(r"\w*kernel", name).group(0)] += ms
        elif (region or part) == "rest":  # the bucket's largest kernels, by name
            rest[name.removeprefix("void ")[:110]] += ms
    busy = sum(parts.values())
    r = {"arch": arch, "n_layers": cfg.n_layers, "optimizer": cfg.optimizer,
         "remat": cfg.remat_policy, "losses": losses, "router_losses": router,
         "wall_s": wall, "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in times["step"]],
         "tokens_per_s": B * S / step_s, "mfu": flops / step_s / PEAK_OPS["bfloat16"],
         "model_flops_per_step": flops, "active_params": cfg.n_active_params(), "peak_gb": peak,
         "launches_per_step": per_step, "save_s": times["save"],
         "k2_launches_by_shape": dict(shapes),
         "profiled_step_device_ms": busy,
         "profiled_step_share": {g: ms / busy for g, ms in parts.most_common()},
         "profiled_step_kernel_ms": dict(kernels.most_common()),
         "profiled_step_rest_ms": dict(rest.most_common(12))}
    report["train" + ("" if arch == "qwen3-1.7b" else f"_{arch}") + tag.replace(" ", "_")] = r
    depth = f"{cfg.n_layers} layers" + (f" of {configs.get_config(arch).n_layers}"
                                        if cut else "")
    arch += tag
    print(f"train ({arch} full width, {depth}, bf16, {B}x{S} tokens, {cfg.optimizer}, remat "
          f"{cfg.remat_policy}): losses {' '.join(f'{x:.4f}' for x in losses)}")
    for k, v in router.items():
        print(f"train {arch}: {k} {' '.join(f'{x:.4f}' for x in v)}")
    print(f"train {arch}: {r['step_ms']:.1f} ms a step (median of steps 2-{TRAIN_STEPS}), "
          f"{r['tokens_per_s']:.0f} tokens/s, MFU {r['mfu']:.1%} of 989 TFLOP/s, peak "
          f"{peak:.1f} GB; launches a step: "
          + ", ".join(f"{k} {n:g}" for k, n in per_step.items())
          + (f"; saves {', '.join(f'{x:.1f}' for x in times['save'])} s" if times["save"] else
             " (no saves)"))
    if shapes:
        print(f"train {arch}: K2 launches by shape in {TRAIN_STEPS} steps: " + ", ".join(
            f"{k} {n}" for k, n in sorted(shapes.items())))
    print(f"train {arch}: profiled step device time {busy:.1f} ms: " + ", ".join(
        f"{g} {ms / busy:.1%}" for g, ms in parts.most_common()))
    print(f"train {arch}: kernels in the profiled step: " + ", ".join(
        f"{k} {ms:.2f} ms" for k, ms in kernels.most_common()))
    print(f"train {arch}: the rest's largest kernels: " + "; ".join(
        f"{k} {ms:.2f} ms" for k, ms in rest.most_common(6)))
    return dict(launches, **shapes)


def restart_phase(report: dict) -> None:
    """(d) Restart determinism on the card: full width at 2 layers, sequence
    512, 12 steps, a checkpoint every 4, uninterrupted and with a failure
    injected at step 6; the final losses must be equal bit for bit."""
    import dataclasses
    import tempfile
    from unittest import mock

    from repro_torch import configs
    from repro_torch.launch import train

    two = dataclasses.replace(configs.get_config("qwen3-1.7b"), n_layers=2)
    runs = []
    with mock.patch.object(configs, "get_config", lambda name: two):
        for fail_at in ("-1", "6"):
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
                runs.append(train.main(["--no-reduced", "--steps", "12", "--seq-len", "512",
                                        "--ckpt-every", "4", "--fail-at", fail_at,
                                        "--ckpt-dir", ck, "--log-every", "100"]))
    a, b = runs
    report["restart"] = {"final_loss": [a["final_loss"], b["final_loss"]],
                         "restarts": b["report"].restarts,
                         "restore_steps": b["report"].restore_steps}
    print(f"restart (2 full-width layers, 12 steps, fail at 6): final loss "
          f"{a['final_loss']!r} uninterrupted, {b['final_loss']!r} restarted "
          f"({b['report'].restarts} restart, from step {b['report'].restore_steps})")
    if b["report"].restarts != 1 or a["final_loss"] != b["final_loss"] or \
            a["losses"] != b["losses"]:
        fail("restart: the restarted run's losses differ from the uninterrupted run's")


# ------------------------------------------------------------------ examples
# examples/*_torch.py, the reference's four examples on the port.  Their
# kernels' shapes: K1 at the reduced serve (3 slots of 96, H = 4, K = 2,
# D = 32), K2's prefill at D = 32 and its training call at head_dim 32
# (forward with lse and backward on copies padded to 64: ``widened``), K4
# at the reduced mamba2's heads (B = 4 rows of launch.train's 64 tokens, H =
# 8, P = 32, N = 16: padded to 64 and 128 for the bf16 kernels)
QUICKSTART = {"serve": (3, 5, 96, 4, 2, 32), "prefill": (3, 16, 4, 2, 32),
              "train": (8, 32, 4, 2, 32)}
RESILIENT = (4, 64, 8, 32, 1, 16)  # B, S, H, P, G, N
EXAMPLE_STEPS = {"quickstart": 80, "train_resilient": 30}


def example_kernel_phase(report: dict) -> dict:
    """The examples' kernels at their shapes, bf16, against the plain
    versions: K1 at the reduced serve for T = 1, 5 and 9; K2's training
    call (``ops.flash_attention`` under autograd at head_dim 32: forward
    with lse at 32, backward padded to 64) and K4's (``ops.ssd_scan`` under
    autograd at P = 32, N = 16, padded) against the plain versions'
    autograd, each launch on the tensor-core kernels; then timed where the
    kernel runs (K1 and K2's prefill as served, K2's training forward at 32,
    the padded calls on the padded copies the kernels get), the bound of the
    unpadded function's work."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda

    g = torch.Generator(device="cuda").manual_seed(21)
    B, T, S, H, K, D = QUICKSTART["serve"]
    lines, e1 = [], 0.0
    for t in (1, T, 9):
        q, k, v, clen, pos = decode_case(g, B, t, S, H, K, D, "bfloat16", [10, 40, 80])
        e1 = max(e1, check(f"decode T={t} D={D}", decode_attention_cuda(
            q, k, v, clen, kv_positions=pos), ref.decode_attention(q, k, v, clen,
                                                                   kv_positions=pos), "bfloat16"))
    out = {"decode_attention (quickstart serve)": decode_timing(g, B, T, S, H, K, D),
           "flash_attention (quickstart prefill)": flash_timing(g, *QUICKSTART["prefill"])}
    out["decode_attention (quickstart serve)"]["err"] = max(
        e1, out["decode_attention (quickstart serve)"]["err"])
    for r in out.values():
        r["max_abs_err"] = r.pop("err")
    pad = torch.nn.functional.pad
    B, S, H, K, D = QUICKSTART["train"]
    q, k, v, dout = (torch.randn(B, S, n, D, generator=g, device="cuda").to(torch.bfloat16)
                     for n in (H, K, K, H))
    Bs, Ss, Hs, P, G, N = RESILIENT
    x, dtv, A, Bm, C, _ = ssd_case(g, Bs, Ss, Hs, P, G, N, "bfloat16")
    dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
    errs = {}
    zero_counts()
    for name, fn, ins, grad, plain in (
            ("K2", ops.flash_attention, (q, k, v), dout,
             lambda *t: (ref.flash_attention(*t),)),
            ("K4", ops.ssd_scan, (x, dtv, A, Bm, C), dy,
             lambda *t: ref.ssd_scan(*t, chunk=256))):
        runs = []
        for f in (fn, plain):
            leaves = [t.clone().requires_grad_() for t in ins]
            y = f(*leaves)
            y = y[0] if isinstance(y, tuple) else y
            runs.append([*torch.autograd.grad(y, leaves, grad), y.detach()])
        errs[name] = max(check(f"{name} under autograd at the reduced shape: output {i}", a, b,
                               "bfloat16", BWD_TOL) for i, (a, b) in enumerate(zip(*runs)))
    launches = read_counts()
    want = {"flash_attention": 1, "flash_attention_bwd": 1, "ssd_scan": 1, "ssd_scan_bwd": 1}
    if any(launches[n] != c or launches[f"{n}.wgmma"] != c for n, c in want.items()):
        fail(f"examples' training kernels: launches {launches}, expected one each on the "
             "tensor-core kernels")
    lines.append(f"K2 at head_dim 32 under autograd (backward padded to 64): max_abs_err {errs['K2']:.3g}; "
                 f"K4 at P=32 N=16 under autograd (padded to 64, 128): {errs['K4']:.3g}")
    print(lines[-1])
    qp, kp, vp, dp = (pad(t, (0, 64 - D)) for t in (q, k, v, dout))
    bwd = bwd_timing(qp, kp, vp, dp)[0]
    bwd["shape"] += " (head_dim 32 zero-padded)"
    bwd["bound"] = bound_ms(*bwd_cost(q, k), "bfloat16")
    th = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    nbytes, n_ops = flash_cost(q, k)
    fwd = {"shape": f"B={B} S={S} H={H} K={K} D={D} causal bf16",
           "ms": timed(lambda i: flash_attention_cuda(q, k, v, lse=True), 20),
           "plain_ms": timed(lambda i: ref.flash_attention(q, k, v), 3),
           "library_ms": timed(lambda i: sdpa(*th, is_causal=True), 20),
           "bound": bound_ms(nbytes + B * H * S * 4, n_ops, "bfloat16")}
    for r in (bwd, fwd):
        r["max_abs_err"] = errs["K2"]
    out["flash_attention_bwd (quickstart training)"] = bwd
    out["flash_attention (quickstart training, lse)"] = fwd
    xp, Bp, Cp, dyp = pad(x, (0, 64 - P)), pad(Bm, (0, 128 - N)), pad(C, (0, 128 - N)), \
        pad(dy, (0, 64 - P))
    shape = f"B={Bs} S={Ss} H={Hs} P=64 G=1 N=128 bf16 (P=32, N=16 zero-padded)"
    out["ssd_scan (train_resilient)"] = {
        "shape": shape, "ms": timed(lambda i: ssd_scan_cuda(xp, dtv, A, Bp, Cp), 200),
        "plain_ms": timed(lambda i: ref.ssd_scan(x, dtv, A, Bm, C, chunk=256), 20),
        "library_ms": None, "bound": bound_ms(*ssd_cost(x, Bm, None), "bfloat16"),
        "max_abs_err": errs["K4"]}
    out["ssd_scan_bwd (train_resilient)"] = {
        "shape": shape, "ms": timed(lambda i: ssd_scan_bwd_cuda(xp, dtv, A, Bp, Cp, dyp), 50),
        "plain_ms": timed(lambda i: plain_ssd_grads(x, dtv, A, Bm, C, dy), 5),
        "library_ms": None, "bound": bound_ms(*ssd_bwd_cost(x, Bm), "bfloat16"),
        "max_abs_err": errs["K4"]}
    for name, r in out.items():
        print(f"{name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {'none' if r['library_ms'] is None else f'%.4f ms' % r['library_ms']}, "
              f"bound {r['bound'][0]:.3g} ms ({r['bound'][1]})")
    report["example_kernels"] = {"checks": lines, **{k: dict(v, bound=list(v["bound"]))
                                                    for k, v in out.items()}}
    return out


def example(name: str):
    sys.path.insert(0, str(ROOT / "examples"))
    import importlib

    return importlib.import_module(name)


def quickstart_phase(report: dict) -> dict:
    """(a) examples/quickstart_torch.py on the card: 80 training steps of
    the reduced qwen3-1.7b (K2 forward and backward each layer), then the
    trained weights served through StreamServe (K1, K2); the loss must fall
    and every handle stream and finish (the example's own checks).  Records
    the wall seconds of each part, the first and last loss and the launches
    of each part (read when StreamServe is built)."""
    from unittest import mock

    quickstart = example("quickstart_torch")
    parts, serve = {}, quickstart.StreamServe

    def counted_serve(*a, **kw):
        parts["train"] = read_counts()
        zero_counts()
        return serve(*a, **kw)

    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(quickstart, "StreamServe", counted_serve):
        out = quickstart.main(steps=EXAMPLE_STEPS["quickstart"], device="cuda")
    parts["serve"] = read_counts()
    r = report["quickstart"] = {
        "wall_s": time.perf_counter() - t0, "train_s": out["train_s"], "serve_s": out["serve_s"],
        "first_loss": out["losses"][0], "last_loss": out["losses"][-1],
        "launches": {p: {k: n for k, n in c.items() if n} for p, c in parts.items()}}
    t, s = parts["train"], parts["serve"]
    if not (t["flash_attention"] and t["flash_attention_bwd"] and s["decode_attention"]
            and s["flash_attention"]) or any(c[n] != c[f"{n}.wgmma"] for c in (t, s)
                                              for n in ("flash_attention", "decode_attention",
                                                        "flash_attention_bwd")):
        fail(f"quickstart: launches {r['launches']}: training must launch K2 forward and "
             "backward, serving K1 and K2, all on the tensor-core kernels")
    print(f"quickstart (reduced qwen3-1.7b, {EXAMPLE_STEPS['quickstart']} steps): loss "
          f"{r['first_loss']:.4f} -> {r['last_loss']:.4f}, training {r['train_s']:.1f} s, "
          f"serving {r['serve_s']:.1f} s; launches {r['launches']}")
    return parts


def serve_cluster_phase(report: dict) -> dict:
    """(d) examples/serve_cluster_torch.py: its engine demo on the card (8
    requests, pair 1 failed after 4 steps; every request completes, those
    still open on pair 0), its simulator parts on the host (model
    predictions, H100 SXM data-sheet profile)."""
    zero_counts()
    t0 = time.perf_counter()
    out = example("serve_cluster_torch").main(device="cuda")
    launches = read_counts()
    r = report["serve_cluster"] = {
        "wall_s": time.perf_counter() - t0, "engine": out["engine"],
        "simulated": {k: out["cluster"][k] for k in ("n", "latency_p50", "latency_p99",
                                                     "aggregate_tput")},
        "launches": {k: n for k, n in launches.items() if n}}
    if not launches["decode_attention"] or launches["decode_attention"] != launches[
            "decode_attention.wgmma"]:
        fail(f"serve_cluster: launches {launches}")
    print(f"serve_cluster: engine {out['engine']}, simulated (model prediction) "
          f"{r['simulated']}; {r['wall_s']:.1f} s; launches {r['launches']}")
    return launches


def resilient_phase(report: dict) -> dict:
    """(b) examples/train_resilient_torch.py on the card: the reduced
    mamba2-2.7b (K4 forward and backward, padded) for 30 steps,
    uninterrupted (A), with a failure (B), compressed (C) and compressed
    with a failure (D): the example's checks, and here B's losses equal A's
    and D's equal C's bit for bit.  Records each run's final loss and K4
    launches."""
    from unittest import mock

    resilient = example("train_resilient_torch")
    train, per_run = resilient.train_main, []

    def counted(argv):
        zero_counts()
        out = train(argv)
        per_run.append({k: n for k, n in read_counts().items() if n})
        return out

    t0 = time.perf_counter()
    with mock.patch.object(resilient, "train_main", counted):
        runs = resilient.main(steps=EXAMPLE_STEPS["train_resilient"], device="cuda")
    r = report["train_resilient"] = {
        "wall_s": time.perf_counter() - t0,
        "final_loss": {k: v["final_loss"] for k, v in runs.items()},
        "restarts": {k: v["report"].restarts for k, v in runs.items()},
        "launches": dict(zip(runs, per_run, strict=True))}
    if runs["A"]["losses"] != runs["B"]["losses"] or runs["C"]["losses"] != runs["D"]["losses"]:
        fail("train_resilient: a restarted run's losses differ from its uninterrupted run's")
    if any(not c.get("ssd_scan_bwd") or c["ssd_scan_bwd"] != c.get("ssd_scan_bwd.wgmma")
           for c in per_run):
        fail(f"train_resilient: K4 launches {per_run}")
    print(f"train_resilient (reduced mamba2-2.7b): final losses {r['final_loss']}, restarts "
          f"{r['restarts']}, {r['wall_s']:.1f} s; launches {r['launches']}")
    return {k: sum(c.get(k, 0) for c in per_run) for k in per_run[0]}


def compressed_phase(report: dict) -> dict:
    """(c) ``launch.train --compress-grads`` on mamba2-2.7b at full width and
    TRAIN_RUNS' depth (train_phase: 8 bf16 steps of 4 x 2048 tokens, no
    saves) beside the uncompressed run: K4's launches a step equal, every
    loss finite, the losses' gap step by step, ms a step and peak against
    the uncompressed run's; then ``compress_decompress`` alone over one
    step's gradients (the model's leaves, random bf16, an fp32 error tree)
    by CUDA events beside its byte bound (each gradient and error element
    read once and written once), one leaf bit for bit against the CPU."""
    import dataclasses
    import math

    import torch

    from repro_torch import configs
    from repro_torch.distributed.compression import MIN_SIZE, GradientCompressor
    from repro_torch.models import build_model
    from repro_torch.params import tree_items, tree_map

    arch = "mamba2-2.7b"
    launches = train_phase(report, arch, extra=("--compress-grads",), tag=" compressed")
    base, comp = report[f"train_{arch}"], report[f"train_{arch}_compressed"]
    if comp["launches_per_step"] != base["launches_per_step"] or not all(
            map(math.isfinite, comp["losses"])):
        fail(f"compressed training: launches a step {comp['launches_per_step']} against "
             f"{base['launches_per_step']}, losses {comp['losses']}")
    comp["loss_gap"] = [a - b for a, b in zip(comp["losses"], base["losses"], strict=True)]
    comp["step_ms_over_uncompressed"] = comp["step_ms"] / base["step_ms"]
    release()
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=TRAIN_RUNS[arch])
    params = build_model(cfg, "cuda").init(0)
    gen = torch.Generator(device="cuda").manual_seed(22)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype)
                     * 1e-3, params)
    c = GradientCompressor()
    err = c.init_error(params)
    del params
    big = [g for _, g in tree_items(grads) if g.numel() >= MIN_SIZE]
    nbytes = sum(g.numel() * (2 * g.element_size() + 8) for g in big)
    leaf = min(big, key=lambda t: t.numel()).clone()
    e0 = torch.randn(leaf.shape, generator=gen, device="cuda") * 1e-5
    on_cpu = c.compress_decompress([leaf.cpu()], [e0.cpu()])
    on_card = c.compress_decompress([leaf], [e0.clone()])
    if not all(torch.equal(a.cpu(), b) for a, b in zip(on_card[0] + on_card[1],
                                                      on_cpu[0] + on_cpu[1], strict=True)):
        fail("compress_decompress: the card and the CPU give different bits")
    ms = timed(lambda i: c.compress_decompress(grads, err), 5)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    comp["compress_decompress"] = {
        "ms": ms, "bound_ms": bound, "bytes": nbytes, "leaves": len(big),
        "elements": sum(g.numel() for g in big)}
    print(f"train {arch} compressed: loss gap a step {' '.join(f'{x:+.4f}' for x in comp['loss_gap'])}"
          f"; {comp['step_ms']:.1f} ms a step against {base['step_ms']:.1f} "
          f"({comp['step_ms_over_uncompressed']:.3f}x), peak {comp['peak_gb']:.1f} GB against "
          f"{base['peak_gb']:.1f}; compress_decompress over one step's {len(big)} leaves "
          f"({comp['compress_decompress']['elements'] / 1e9:.3f}B elements): {ms:.3f} ms, bound "
          f"{bound:.3f} ms ({nbytes / 1e9:.2f} GB at 3.35 TB/s), {ms / bound:.1f}x")
    del grads, err
    return launches


DIST_MOE = "qwen3-moe-30b-a3b"  # one full-width MoE layer: d 2048, 128 experts top-8, f 768
DIST_SHAPES = {"verify 8x5": (8, 5), "prefill 4x512": (4, 512)}
CP_FILL = [40, 250, 253, 255, 300, 500, 7, 128]  # 253 + 5 crosses into the second rank's slots


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_moe(seed: int = 31):
    """The full-width MoE layer in bf16 from a seeded init, and its inputs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(DIST_MOE)
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = moe.init_moe(g, cfg, torch.bfloat16, "cuda")
    xs = {k: torch.randn(B, S, cfg.d_model, generator=g, device="cuda").bfloat16()
          for k, (B, S) in DIST_SHAPES.items()}
    return cfg, p, xs


@contextlib.contextmanager
def counted_calls(module, name: str):
    """Count the calls of ``module.name`` (the path a mesh selects)."""
    fn, calls = getattr(module, name), []

    def call(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    setattr(module, name, call)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def wall_ms(fn, iters: int = 20) -> float:
    """Mean wall milliseconds a call, synchronised each time: across
    processes over gloo the collectives wait on the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def all_reduce_ms(mesh, *tensors) -> float:
    """Wall ms of the all-reduces a call makes over "model" (tensors of its
    shapes and types), on every rank together."""
    import torch.distributed as dist

    ts = [t.cuda() for t in tensors]
    return wall_ms(lambda: [dist.all_reduce(t, group=mesh.get_group("model")) for t in ts])


def distributed_phase(report: dict) -> None:
    """M11 on the card.  (a) One rank over NCCL on a (1, 1) data x model
    mesh: the full-width qwen3-moe MoE layer through ``apply_moe`` under
    ``use_mesh`` (the expert-parallel path: every call counted, one real NCCL
    all-reduce) against the same layer without a mesh, bf16 2e-2 and whether
    the bits are equal, each timed, the all-reduce alone too; no K1-K4
    launch on this path.  (b) Two ranks on the one card over gloo (NCCL
    refuses two ranks on one device; gloo's CUDA all-reduce is all that
    context-parallel decode and the MoE layer need): ``distributed_rank``."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding
    from repro_torch.models import moe

    res = report["distributed"] = {}
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = sharding.make_mesh((1, 1))
        cfg, p, xs = dist_moe()
        local = sharding.shard_params(p, sharding.param_axes({"moe": p})["moe"], mesh,
                                      sharding.INFERENCE_RULES)

        def ep(x):
            with sharding.use_mesh(mesh):
                return moe.apply_moe(local, cfg, x)

        zero_counts()
        with counted_calls(moe, "apply_moe_expert_parallel") as calls:
            got = {k: ep(x) for k, x in xs.items()}
        if len(calls) != len(xs) or any(read_counts().values()):
            fail(f"distributed (a): {len(calls)} expert-parallel calls of {len(xs)}, "
                 f"launches {read_counts()}")
        for k, x in xs.items():
            want = moe.apply_moe(p, cfg, x)
            r = {"max_abs_err": check(f"EP MoE {k}", got[k], want, "bfloat16"),
                 "bit_equal": bool(torch.equal(got[k], want)),
                 "ms": timed(lambda i, x=x: ep(x), 20),
                 "plain_ms": timed(lambda i, x=x: moe.apply_moe(p, cfg, x), 20),
                 "all_reduce_ms": timed(lambda i: dist.all_reduce(
                     got[k], group=mesh.get_group("model")), 50)}
            r["all_reduce_share"] = r["all_reduce_ms"] / r["ms"]
            res[f"(a) EP MoE {k}"] = r
            print(f"distributed (a): qwen3-moe MoE layer {k}, 1 rank over NCCL: expert parallel "
                  f"{r['ms']:.4f} ms, no mesh {r['plain_ms']:.4f} ms, all-reduce "
                  f"{r['all_reduce_ms']:.4f} ms ({r['all_reduce_share']:.1%}); max abs err "
                  f"{r['max_abs_err']:.3g}, bit-equal {r['bit_equal']}")
        for arch in TP_ARCHS:  # M12: the tensor-parallel layers on one rank
            for step, (got, want, _) in tp_layer(mesh, arch, "bfloat16")[0].items():
                if not torch.equal(got, want):
                    fail(f"distributed (a): {arch} {step} on one NCCL rank is not bit-equal "
                         f"to the layer without a mesh")
            print(f"distributed (a): {arch} layer on one NCCL rank: prefill and verify "
                  f"bit-equal to the layer without a mesh")
    finally:
        dist.destroy_process_group()
    del p, local, xs, got
    release()
    run = tempfile.mkdtemp(prefix="m11-")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--distributed-rank",
                               str(r), run], env=dict(  # two ranks share the card's memory
                                   os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
             for r in range(2)]
    try:
        codes = [proc.wait(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    if codes != [0, 0]:
        fail(f"distributed (b): the two ranks exited {codes}")
    res.update(json.loads((Path(run) / "rank0.json").read_text()))
    t = time.perf_counter()
    elastic_parent(run, res)
    res["(b) resilient training"]["parent_s"] = time.perf_counter() - t
    for name, r in res.items():
        if name.startswith("(b)"):
            if "all_reduce_ms" in r:
                r["all_reduce_share"] = r["all_reduce_ms"] / r["ms"]
            print(f"distributed {name}: " + ", ".join(f"{k} {v:.4g}" for k, v in r.items()))
    report["distributed_s"] = time.perf_counter() - t0
    print(f"distributed: the group took {report['distributed_s']:.1f} s")


def distributed_rank(rank: int, run: str) -> None:
    """One of (b)'s two ranks, both on the one card, over gloo on a (1, 2)
    data x model mesh.  Context-parallel decode of qwen3-1.7b's attention at
    full width (H 16, K 8, D 128, B 8, T 5, a 512-slot cache: 256 slots a
    rank; CP_FILL, one verify crossing the ranks' boundary), bf16 and fp32:
    the CP core against K1 on the whole cache after the same write (the
    tolerances of TOL; the written slots equal), and ``attention_decode``
    under the mesh against the layer without one (K1 inside); the qwen3-moe
    layer with 64 experts a rank against the one-rank layer (bf16 2e-2);
    M12's tensor-parallel layers (``tp_layer``: fp32 within TP_TOL, bf16 by
    ``bf16_error``); the training steps under a mesh (``MESH_TRAIN``);
    resilient training: compressed steps (``MESH_COMPRESSED``) and a
    checkpoint saved at data = 2 and restored (``elastic_mesh_case``).  Each
    timed beside K1 or the one-rank layer (rank 0 alone, the other waiting).
    Rank 0 writes rank0.json."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.models import attention, moe

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{run}/rendezvous", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    mesh = sharding.make_mesh((1, 2))
    j, res, acfg = mesh.get_coordinate()[1], {}, get_config("qwen3-1.7b")
    H, K, D, B, T, S = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim, 8, 5, 512
    g = torch.Generator(device="cuda").manual_seed(41)
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        q, kn, vn = (torch.randn(B, T, n, D, generator=g, device="cuda").to(dtype)
                     for n in (H, K, K))
        clen = torch.tensor(CP_FILL, dtype=torch.int32, device="cuda")
        slot = torch.arange(S, device="cuda")
        whole = {"k": torch.randn(B, S, K, D, generator=g, device="cuda").to(dtype),
                 "v": torch.randn(B, S, K, D, generator=g, device="cuda").to(dtype),
                 "kv_pos": torch.where(slot < clen[:, None], slot, -1).int()}

        def mine():
            return {k: v[:, 256 * j:256 * (j + 1)].clone() for k, v in whole.items()}

        def cp(cache):
            with sharding.use_mesh(mesh):
                return attention._decode_attention_cp(mesh, acfg, q, kn, vn, cache, clen)

        cache, ref = mine(), {k: v.clone() for k, v in whole.items()}
        got = cp(cache)
        attention.write_cache(ref["k"], ref["v"], ref["kv_pos"], kn, vn, clen)
        want = ops.decode_attention(q, ref["k"], ref["v"], clen + T, kv_positions=ref["kv_pos"])
        if any(not torch.equal(cache[k], ref[k][:, 256 * j:256 * (j + 1)]) for k in cache):
            fail(f"distributed (b): rank {rank}'s written slots differ from the whole write")
        err = check(f"CP decode {dt}", got, want, dt)
        p = attention.init_attention(g, acfg, dtype, "cuda")
        x = torch.randn(B, T, acfg.d_model, generator=g, device="cuda").to(dtype)
        with sharding.use_mesh(mesh):
            layer = attention.attention_decode(p, acfg, x, mine(), clen)
        check(f"CP attention_decode {dt}", layer, attention.attention_decode(
            p, acfg, x, {k: v.clone() for k, v in whole.items()}, clen), dt)
        r = {"max_abs_err": err, "ms": wall_ms(lambda: cp(cache)),  # the same writes again
             "all_reduce_ms": all_reduce_ms(mesh, torch.zeros(B, K, H // K, T),
                                            torch.zeros(B, K, H // K, T, D + 1))}
        dist.barrier()
        if rank == 0:
            r["k1_ms"] = timed(lambda i: ops.decode_attention(
                q, ref["k"], ref["v"], clen + T, kv_positions=ref["kv_pos"]), 50)
        dist.barrier()
        res[f"(b) CP decode {dt}"] = r
    cfg, p, xs = dist_moe()
    local = sharding.shard_params(p, sharding.param_axes({"moe": p})["moe"], mesh,
                                  sharding.INFERENCE_RULES)
    if local["wi"].shape[0] != 64:
        fail(f"distributed (b): rank {rank} holds {local['wi'].shape[0]} experts, not 64")
    for k, x in xs.items():
        want = moe.apply_moe(p, cfg, x)  # one rank, no mesh
        with sharding.use_mesh(mesh):
            r = {"max_abs_err": check(f"EP MoE 2 ranks {k}", moe.apply_moe(local, cfg, x), want,
                                      "bfloat16"),
                 "ms": wall_ms(lambda x=x: moe.apply_moe(local, cfg, x)),
                 "all_reduce_ms": all_reduce_ms(mesh, want)}
        dist.barrier()
        if rank == 0:
            r["one_rank_ms"] = timed(lambda i, x=x: moe.apply_moe(p, cfg, x), 20)
        dist.barrier()
        res[f"(b) EP MoE 2 ranks {k}"] = r
    del p, local, xs
    for arch in TP_ARCHS:
        for dt in ("bfloat16", "float32"):
            pairs, r = tp_layer(mesh, arch, dt, timed_rank=rank == 0)
            for step, (got, want, exact) in pairs.items():
                tag = f"TP {arch} {step} {dt}"
                if exact is None:
                    r[f"{step}_max_abs_err"] = check(tag, got, want, dt, TP_TOL)
                else:
                    r.update({f"{step}_{k}": v for k, v in bf16_error(
                        tag, got, want, exact, get_config(arch).vocab_size).items()})
            res[f"(b) TP {arch} {dt}"] = r
    del pairs
    release()  # the layers above leave reference cycles: their weights go with the collector
    meshes = {(1, 2): mesh, (2, 1): sharding.make_mesh((2, 1))}
    for name, (arch, n_layers, shape, fsdp, B) in MESH_TRAIN.items():
        for dt in ("float32", "bfloat16"):
            res[f"(b) train {name} {dt}"] = train_mesh_case(
                meshes[shape], name, arch, n_layers, dt, fsdp, B, rank == 0 and dt == "bfloat16")
            release()
    t = time.perf_counter()
    for name, (arch, n_layers, shape, B) in MESH_COMPRESSED.items():  # resilient training
        for dt in ("float32", "bfloat16"):
            res[f"(b) compressed {name} {dt}"] = compressed_mesh_case(
                meshes[shape], name, arch, n_layers, dt, B, dt == "bfloat16")
            release()
            if rank == 0:
                print(f"[{time.perf_counter() - t:.1f} s] distributed (b) compressed {name} {dt} "
                      "passed", flush=True)
    res["(b) checkpoint"], res["no-mesh continuation"] = elastic_mesh_case(meshes, run)
    res["(b) resilient training"] = {"rank_s": time.perf_counter() - t}
    if rank == 0:
        (Path(run) / "rank0.json").write_text(json.dumps(res))
    dist.destroy_process_group()


# (b)'s training steps under a mesh: name -> (arch, layers, (data, model),
# FSDP, rows); each at S = 2048, its embedding and loss included (two ranks
# on the one card: qwen3's 151,936-column fp32 logits cost 2.5 GB a row)
MESH_TRAIN = {"qwen3 ZeRO-1 data=2": ("qwen3-1.7b", 2, (2, 1), False, 2),
              "qwen3 FSDP data=2": ("qwen3-1.7b", 2, (2, 1), True, 2),
              "qwen3 model=2": ("qwen3-1.7b", 2, (1, 2), False, 4),
              "mamba2 model=2": ("mamba2-2.7b", 1, (1, 2), False, 4),
              "qwen3-moe model=2": ("qwen3-moe-30b-a3b", 1, (1, 2), False, 2)}
STEP_TOL = 1e-2  # (b): a step's change to a parameter shard against the change without a mesh
MESH_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")


def mesh_train_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    fns = (fa.flash_attention_cuda, fa.flash_attention_bwd_cuda, ssd.ssd_scan_cuda,
           ssd.ssd_scan_bwd_cuda)
    return {k: f.launches for k, f in zip(MESH_TRAIN_KERNELS, fns, strict=True)}


def train_mesh_case(mesh, name: str, arch: str, n_layers: int, dt: str, fsdp: bool, B: int,
                    timed_rank: bool, S: int = 2048, seed: int = 45) -> dict:
    """One AdamW step of ``arch`` (full width, ``n_layers`` layers, in dtype
    dt) on this rank's shards under ``mesh`` (ZeRO-1, or FSDP with its rules
    forced), against the same step without a mesh on the whole weights and
    batch: fp32 loss within 1e-5 (relative), each gradient shard within 1e-4
    x max |g| of its place in the whole gradient, the parameters after the
    step within 1e-4 (MoE 2e-4) and the change the step makes to each
    parameter shard (~3e-6 at warmup's first step) within ``STEP_TOL`` of the
    change without a mesh, in norm; bf16 by ``bf16_error`` on the gradients
    (the step without a mesh in fp32 the exact one).  With ``timed_rank`` set,
    wall ms a step under the mesh and its collectives' ms (both ranks), and
    on rank 0 the step without a mesh."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models.model import Model
    from repro_torch.params import tree_items, tree_map
    from repro_torch.training.train_loop import make_train_step

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype=dt)
    params = Model(cfg, "cuda").init(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda",
                           dtype=torch.int32)

    def step(p, batch, c=cfg):
        """(loss, the gradients before the update, in fp32 each parameter
        after the update and, on the host, the change it made (the card holds
        no more than the step does))."""
        init_opt, ts = make_train_step(Model(c, "cuda"))
        opt = init_opt(p)
        _, m, grads = ts.grads(p, batch)
        kept, was = [x.clone() for _, x in tree_items(grads)], None
        if dt == "float32":
            was = [x.cpu() for _, x in tree_items(p)]
            p = ts.update(p, opt, grads, m)[0]
        del opt, grads
        return float(m["loss"].detach()), kept, was and [
            (x, (x - w.cuda()).cpu()) for (_, x), w in zip(tree_items(p), was, strict=True)]

    want = step(tree_map(torch.clone, params), {"tokens": tokens})
    sizes = sharding.mesh_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate(), strict=True))
    rules = sharding.DEFAULT_RULES if fsdp else sharding.ZERO1_PARAM_RULES
    rows = {"tokens": tokens[coord["data"] * B // sizes["data"]:
                             (coord["data"] + 1) * B // sizes["data"]]}
    with sharding.use_mesh(mesh), sharding.use_rules(rules):
        local = sharding.shard_params(params, sharding.param_axes(params), mesh, rules, cfg)
        before = mesh_train_counts()
        got = step(local, rows)
        r = {f"{k}_launches": v - before[k] for k, v in mesh_train_counts().items()}

    def places(rules):
        out = []
        for w, ax in zip([w for _, w in tree_items(params)],
                         sharding.axes_leaves(sharding.param_axes(params)), strict=True):
            spec = sharding.logical_to_spec(ax, sizes, rules, w.shape)
            shape, starts = sharding.local_shape(w.shape, spec, sizes, coord)
            out.append([(d, a, n) for d, (a, n) in enumerate(zip(starts, shape, strict=True))])
        return out

    def at(t, place):
        for d, a, n in place:
            t = t.narrow(d, a, n)
        return t

    tag = f"distributed (b) train {name} {dt}"
    r["loss"], r["no_mesh_loss"] = got[0], want[0]
    if dt == "float32":
        if abs(got[0] - want[0]) > 1e-5 * max(1.0, abs(want[0])):
            fail(f"{tag}: loss {got[0]} against {want[0]} without a mesh")
        r["grad_err"] = max(max_err(a, at(b, pl)) / max(float(b.abs().max()), 1e-30)
                            for a, b, pl in zip(got[1], want[1], places(sharding.DEFAULT_RULES),
                                                strict=True))
        pairs = list(zip(got[2], want[2], places(rules), strict=True))
        r["param_err"] = max(max_err(a, at(b, pl)) for (a, _), (b, _), pl in pairs)
        r["step_err"] = max(float((a - at(b, pl)).norm() / at(b, pl).norm().clamp(min=1e-30))
                            for (_, a), (_, b), pl in pairs)
        if (r["grad_err"] > 1e-4 or r["param_err"] > (2e-4 if cfg.moe else 1e-4)
                or r["step_err"] > STEP_TOL):
            fail(f"{tag}: gradients {r['grad_err']:.3g} x max |g|, parameters "
                 f"{r['param_err']:.3g}, a step's change {r['step_err']:.3g} (in norm) from the "
                 "step without a mesh")
    else:
        exact = step(tree_map(lambda t: t.float(), params), {"tokens": tokens},
                     dataclasses.replace(cfg, dtype="float32"))
        pl = places(sharding.DEFAULT_RULES)
        flat = [torch.cat([(x if v is got[1] else at(x, p)).float().flatten()
                           for x, p in zip(v, pl, strict=True)])
                for v in (got[1], want[1], exact[1])]
        r.update(bf16_error(tag + " gradients", *flat, None))
    if dt == "bfloat16":  # both ranks time a training step under the mesh (warm: the
        # checks ran it), then one with its collectives synchronised around each
        def timer(p, batch):
            init_opt, ts = make_train_step(Model(cfg, "cuda"))
            opt = init_opt(p)
            return lambda: ts(p, opt, batch)

        def once_ms(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3

        with sharding.use_mesh(mesh), sharding.use_rules(rules):
            r["ms"] = once_ms(timer(local, rows))
            r["collective_ms"] = collective_ms(timer(local, rows))
        r["collective_share"] = r["collective_ms"] / r["ms"]
        release()
        dist.barrier()
        if timed_rank:
            r["no_mesh_ms"] = wall_ms(timer(tree_map(torch.clone, params), {"tokens": tokens}), 1)
        dist.barrier()
    return r


# (b)'s compressed steps under a mesh: name -> (arch, layers, (data, model), rows), at S = 2048
MESH_COMPRESSED = {"qwen3 ZeRO-1 data=2": ("qwen3-1.7b", 2, (2, 1), 2),
                   "qwen3 model=2": ("qwen3-1.7b", 2, (1, 2), 4),
                   "mamba2 model=2": ("mamba2-2.7b", 1, (1, 2), 4)}


def _at(t, starts, shape):
    """t's piece at ``starts`` of ``shape`` (a dimension of 1 broadcast)."""
    for d, (a, n) in enumerate(zip(starts, shape, strict=True)):
        t = t.narrow(d, a, n) if t.shape[d] > 1 else t
    return t


def compressed_mesh_case(mesh, name: str, arch: str, n_layers: int, dt: str, B: int,
                         timed_rank: bool, S: int = 2048, seed: int = 47) -> dict:
    """One AdamW step of ``arch`` (full width, ``n_layers`` layers, in dtype
    dt) with int8 gradient compression on this rank's shards under ``mesh``
    (ZeRO-1), against the compressed step without a mesh on the whole
    weights and batch.  fp32 with the limits of the CPU test of compressed
    steps: the loss within 1e-5 (relative); the parameter shards within 1e-4
    and the error tree's within 1e-6 of their place, but at the entries a
    rounding flip moved (at most 1e-3 of them), where within 2 lr + 1e-4 and
    one quantum of the row (max |g| / 127) + 1e-6; away from the flips the
    change the step makes to the rank's optimizer piece within ``STEP_TOL``
    of the change without a mesh, in norm.  bf16, against the fp32 step
    without a mesh: the gradients the round trip takes (reduced over the
    batch axes) and the dequantised ones (the optimizer's input), each by
    its mean error within 1.25x the bf16 step's without a mesh, and the
    gradients' largest error within 1.25x its largest plus one bf16 ulp of
    the largest gradient (a largest error is one entry's rounding: the two
    sides differ by an ulp there; a dequantised one is a flipped entry's
    quantum, printed).  K2's and K4's launches under the mesh counted; with
    ``timed_rank``, wall ms a step under the mesh (both ranks) and on rank 0
    without one."""
    import dataclasses
    import math

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed.compression import GradientCompressor
    from repro_torch.models.model import Model
    from repro_torch.params import tree_items, tree_map
    from repro_torch.training.train_loop import make_train_step

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype=dt)
    params = Model(cfg, "cuda").init(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda",
                           dtype=torch.int32)

    def step(p, batch, c=cfg):
        """(loss, lr, on the host: the dequantised gradients, the error tree,
        the parameters after the step and their change, each row's quantum;
        the places of the rank's leaves; the gradients before the round trip)."""
        init_opt, ts = make_train_step(Model(c, "cuda"), compression=GradientCompressor())
        opt = init_opt(p)
        _, m, grads = ts.grads(p, batch)
        before = [x.float().cpu() for _, x in tree_items(grads)]
        quanta = [x.float().abs().amax(-1, keepdim=True).div_(127.0).cpu() if x.dim() else x.cpu()
                  for _, x in tree_items(grads)]
        was = [x.cpu() for _, x in tree_items(p)]
        p, opt, m = ts.update(p, opt, grads, m)
        out = (float(m["loss"]), float(m["lr"]), [x.float().cpu() for _, x in tree_items(grads)],
               [x.cpu() for _, x in tree_items(opt[1])],
               [(x.float().cpu(), (x.cpu() - w).float()) for (_, x), w in zip(
                   tree_items(p), was, strict=True)], quanta, ts.places(p), before)
        del opt, grads
        return out

    want = step(tree_map(torch.clone, params), {"tokens": tokens})
    sizes = sharding.mesh_sizes(mesh)
    i = sharding.mesh_coord(mesh)["data"]
    rows = {"tokens": tokens[i * B // sizes["data"]:(i + 1) * B // sizes["data"]]}
    rules = sharding.ZERO1_PARAM_RULES
    with sharding.use_mesh(mesh), sharding.use_rules(rules):
        local = sharding.shard_params(params, sharding.param_axes(params), mesh, rules, cfg)
        before = mesh_train_counts()
        got = step(local, rows)
        r = {f"{k}_launches": v - before[k] for k, v in mesh_train_counts().items()}
    tag, places = f"distributed (b) compressed {name} {dt}", got[6]
    n, pieces = len(places["params"]), places["opt"][-len(places["params"]):]
    if not r["flash_attention_launches" if arch.startswith("qwen3") else "ssd_scan_launches"] \
            or not r["flash_attention_bwd_launches" if arch.startswith("qwen3")
                     else "ssd_scan_bwd_launches"]:
        fail(f"{tag}: launches {r}")
    r["loss"], r["no_mesh_loss"] = got[0], want[0]
    if dt == "float32":
        if abs(got[0] - want[0]) > 1e-5 * max(1.0, abs(want[0])):
            fail(f"{tag}: loss {got[0]} against {want[0]} without a mesh")
        lr, past, size, step_err = want[1], 0, 0, 0.0
        for (x, dx), (y, dy), a, e, we, q, piece in zip(got[4], want[4], places["params"], got[3],
                                                       want[3], want[5], pieces, strict=True):
            d, de = (x - _at(y, a, x.shape)).abs(), (e - _at(we, piece, e.shape)).abs()
            quantum = _at(q, piece, e.shape)
            if not bool((d <= 2 * lr + 1e-4).all()) or not bool((de <= quantum + 1e-6).all()):
                fail(f"{tag}: a parameter or error shard beyond a flip's reach")
            past += int((d > 1e-4).sum()) + int((de > 1e-6).sum())
            size += d.numel() + de.numel()
            keep = de <= 1e-6  # the rank's optimizer piece away from the flips
            mine = _at(dx, [b - c for b, c in zip(piece, a, strict=True)], e.shape) * keep
            theirs = _at(dy, piece, e.shape) * keep
            step_err = max(step_err, float((mine - theirs).norm() / theirs.norm().clamp(min=1e-30)))
        r["flips"], r["step_err"] = past, step_err
        if past > 1e-3 * size or step_err > STEP_TOL:
            fail(f"{tag}: {past} entries past the limits of {size}, a step's change "
                 f"{step_err:.3g} (in norm) from the step without a mesh")
    else:
        exact = step(tree_map(lambda t: t.float(), params), {"tokens": tokens},
                     dataclasses.replace(cfg, dtype="float32"))
        flat = {i: [torch.cat([(x if v is got else _at(x, piece, mine.shape)).flatten()
                               for x, piece, mine in zip(v[i], pieces, got[i], strict=True)])
                    for v in (got, want, exact)] for i in (2, 7)}
        for i, k in ((7, "grad"), (2, "deq")):
            errs = [(x - flat[i][2]).abs() for x in flat[i][:2]]
            r[f"{k}_max_err"], r[f"{k}_no_mesh_max_err"] = (float(e.max()) for e in errs)
            r[f"{k}_mean_err"], r[f"{k}_no_mesh_mean_err"] = (float(e.mean()) for e in errs)
        ulp = 2.0 ** (math.floor(math.log2(float(flat[7][2].abs().max()))) - 7)
        if r["grad_max_err"] > 1.25 * r["grad_no_mesh_max_err"] + ulp or any(
                r[f"{k}_mean_err"] > 1.25 * r[f"{k}_no_mesh_mean_err"] for k in ("grad", "deq")):
            fail(f"{tag}: bf16 errors against the fp32 step without a mesh {r} (one bf16 ulp "
                 f"of the largest gradient {ulp:.3g})")
        del exact, flat
    if timed_rank:  # ms a step under the mesh on both ranks, then without one on rank 0
        def timer(p, batch):
            init_opt, ts = make_train_step(Model(cfg, "cuda"), compression=GradientCompressor())
            opt = init_opt(p)
            return lambda: ts(p, opt, batch)

        with sharding.use_mesh(mesh), sharding.use_rules(rules):
            r["ms"] = wall_ms(timer(local, rows), 1)
        release()
        dist.barrier()
        if sharding.mesh_coord(mesh) == {a: 0 for a in sizes}:
            r["no_mesh_ms"] = wall_ms(timer(tree_map(torch.clone, params), {"tokens": tokens}), 1)
        dist.barrier()
    return r


ELASTIC_BATCH = (2, 2048, 48)  # (ii)-(iii): rows, tokens a row, seed


def elastic_mesh_case(meshes, run: str) -> dict:
    """Full-width qwen3-1.7b at 2 layers, fp32, compressed, under ZeRO-1 at
    data = 2: two steps, a checkpoint (whole arrays from the two ranks'
    shards), two more steps (the uninterrupted run).  The checkpoint then
    restores at data = 2 (the restart: two steps, bit-equal to the
    uninterrupted run's losses and shards), without a mesh on each rank (two
    steps: the run the others are held to, its losses and grad norms kept
    for the parent's restore) and at model = 2 (two steps, held to the run
    without a mesh: loss 1e-5, grad norm 1e-4 relative, parameters within 2
    lr for each step, as a held compressed step: a rounding flip moves an
    entry by up to its step's lr and AdamW carries it); each restored shard
    bit-equal to its slice of the whole arrays.  Deterministic algorithms
    on, as launch.train sets them.  Save and restore seconds, the
    checkpoint's bytes, ms a step."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed.compression import GradientCompressor
    from repro_torch.models.model import Model
    from repro_torch.params import tree_items
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.train_loop import make_train_step

    from repro_torch.training.optimizer import OptConfig, lr_schedule

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2, dtype="float32")
    B, S, seed = ELASTIC_BATCH
    tokens = elastic_tokens(cfg)
    ck, res = CheckpointManager(f"{run}/ckpt", keep=1), {}
    rules = sharding.ZERO1_PARAM_RULES

    def go(mesh, state, first, n):
        """n steps from step ``first``: (state, losses, grad norms, ms a step)."""
        i, k = (sharding.mesh_coord(mesh)["data"], mesh.shape[0]) if mesh else (0, 1)
        init_opt, ts = make_train_step(Model(cfg, "cuda"), compression=GradientCompressor())
        p, opt = state[:2] if isinstance(state, tuple) else (state, init_opt(state))
        losses, norms = [], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for s in range(first, first + n):
            p, opt, m = ts(p, opt, {"tokens": tokens[s][i * B // k:(i + 1) * B // k]})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return (p, opt), losses, norms, (time.perf_counter() - t) / n * 1e3, ts

    def restored(mesh, key):
        """The checkpoint restored under ``mesh`` (None: whole), timed:
        (parameters, optimizer state, places)."""
        model = Model(cfg, "cuda")
        init_opt, ts = make_train_step(model, compression=GradientCompressor())
        p = model.init(0)
        if mesh is not None:
            p = sharding.shard_params(p, sharding.param_axes(p), mesh, rules, cfg)
        places = ts.places(p)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, back = ck.restore({"params": p, "opt": init_opt(p)}, places=places)
        torch.cuda.synchronize()
        res[f"{key}_restore_s"] = time.perf_counter() - t
        return back["params"], back["opt"], places

    mesh = meshes[(2, 1)]
    with sharding.use_mesh(mesh), sharding.use_rules(rules):
        whole = Model(cfg, "cuda").init(seed)
        state, losses, _, ms, ts = go(mesh, sharding.shard_params(
            whole, sharding.param_axes(whole), mesh, rules, cfg), 0, 2)
        del whole
        t = time.perf_counter()
        ck.save(2, {"params": state[0], "opt": state[1], "meta": {"step": 2}},
                places=ts.places(state[0]))
        res["save_s"] = time.perf_counter() - t
        res["checkpoint_bytes"] = sum(f.stat().st_size for f in Path(
            f"{run}/ckpt/step_00000002").iterdir())
        state, more, _, res["data2_ms"], _ = go(mesh, state, 2, 2)
        again, again_losses, _, _, _ = go(mesh, restored(mesh, "data2"), 2, 2)
        res["restart_bit_equal"] = again_losses == more and all(torch.equal(a, b) for (_, a), (
            _, b) in zip(tree_items(state), tree_items(again), strict=True))
        if not res["restart_bit_equal"]:
            fail(f"distributed (b) restart at data = 2: losses {again_losses} against {more}")
        del state, again
    release()
    whole, want, want_norms, res["no_mesh_ms"], _ = go(None, restored(None, "no_mesh"), 2, 2)
    mesh = meshes[(1, 2)]
    with sharding.use_mesh(mesh), sharding.use_rules(rules):
        *state, places = restored(mesh, "model2")
        leaves = CheckpointManager(f"{run}/ckpt").read()[1]
        res["restored_bit_equal"] = all(torch.equal(x.cpu(), _at(leaves[f"{g}/{k}"], a, x.shape))
                                        for g, t in zip(("params", "opt"), state)
                                        for (k, x), a in zip(tree_items(t), places[g], strict=True))
        del leaves
        state, losses, norms, res["model2_ms"], _ = go(mesh, tuple(state), 2, 2)
    lr = 2 * sum(float(lr_schedule(OptConfig(), s)) for s in (3, 4))  # 2 lr a step
    res["model2_param_err"] = max(float((x - _at(w, a, x.shape)).abs().max()) for (_, x), (
        _, w), a in zip(tree_items(state[0]), tree_items(whole[0]), places["params"], strict=True))
    if not res["restored_bit_equal"] or any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(
            losses, want, strict=True)) or any(abs(a - b) > 1e-4 * b for a, b in zip(
                norms, want_norms, strict=True)) or res["model2_param_err"] > lr:
        fail(f"distributed (b) restore at model = 2: shards bit-equal "
             f"{res['restored_bit_equal']}, losses {losses} against {want}, grad norms {norms} "
             f"against {want_norms}, parameters {res['model2_param_err']:.3g} (2 lr a step: "
             f"{lr:.3g})")
    torch.use_deterministic_algorithms(False)
    return res, {"losses": want, "grad_norms": want_norms}


def elastic_parent(run: str, res: dict) -> None:
    """(ii)'s restore in this process, without a mesh or a process group:
    two steps from the ranks' checkpoint, held to the ranks' run without a
    mesh from it (loss 1e-5, grad norm 1e-4 relative; whether the losses are
    the same bits is printed: this process is not in deterministic mode)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import GradientCompressor
    from repro_torch.models.model import Model
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.train_loop import make_train_step

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2, dtype="float32")
    tokens, model = elastic_tokens(cfg), Model(cfg, "cuda")
    init_opt, ts = make_train_step(model, compression=GradientCompressor())
    p = model.init(0)
    t = time.perf_counter()
    _, back = CheckpointManager(f"{run}/ckpt").restore({"params": p, "opt": init_opt(p)})
    torch.cuda.synchronize()
    r, want = {"restore_s": time.perf_counter() - t}, res.pop("no-mesh continuation")
    p, opt, got = back["params"], back["opt"], []
    for s in (2, 3):
        p, opt, m = ts(p, opt, {"tokens": tokens[s]})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    r["loss_rel_err"] = max(abs(a - b) / b for (a, _), b in zip(got, want["losses"], strict=True))
    r["grad_norm_rel_err"] = max(abs(a - b) / b for (_, a), b in zip(got, want["grad_norms"],
                                                                      strict=True))
    r["losses_bit_equal"] = [a for a, _ in got] == want["losses"]
    res["(b) checkpoint restored in the parent, no mesh"] = r
    shutil.rmtree(Path(run) / "ckpt", ignore_errors=True)
    if r["loss_rel_err"] > 1e-5 or r["grad_norm_rel_err"] > 1e-4:
        fail(f"distributed (b) restore in the parent: {r}")


def elastic_tokens(cfg):
    """The four steps' tokens of ``elastic_mesh_case`` (the same in every process)."""
    import torch

    B, S, seed = ELASTIC_BATCH
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (4, B, S), generator=g, device="cuda",
                         dtype=torch.int32)


TP_ARCHS = ("qwen3-1.7b", "mamba2-2.7b")
TP_TOL = {"float32": 1e-5}  # bf16: bf16_error
TP_SHAPES = {"prefill": (4, 2048), "verify": (4, 5)}


def tp_layer(mesh, arch: str, dt: str, timed_rank=None, seed: int = 43):
    """One full-width layer of ``arch`` (with its embedding and head) in dtype
    dt: a 4 x 2048 prefill and a 4 x 5 verify on this rank's shards under
    ``mesh`` (``shard_params`` under INFERENCE_RULES: tensor parallel where
    its "model" axis is larger than 1), and the same without a mesh on the
    whole weights.  Returns ({step: (logits under the mesh, without)}, and
    K2/K4 launches under the mesh; with ``timed_rank`` set and a "model"
    axis larger than 1, wall ms a call, the ms its collectives take and,
    on the timed rank, the ms without a mesh)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(arch), n_layers=1, dtype=dt)
    model = Model(cfg, "cuda")
    params = model.init(seed)
    local = sharding.shard_params(params, sharding.param_axes(params), mesh,
                                  sharding.INFERENCE_RULES, cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = {k: torch.randint(0, cfg.vocab_size, s, generator=g, device="cuda", dtype=torch.int32)
            for k, s in TP_SHAPES.items()}

    def run(p):
        logits, cache = model.prefill(p, {"tokens": toks["prefill"]}, 2560)
        return {"prefill": logits, "verify": model.decode_step(p, cache, toks["verify"])}

    with torch.no_grad():
        want = run(params)
        exact = {k: None for k in want}
        if dt == "bfloat16":  # the same weights in float32, without a mesh
            model = Model(dataclasses.replace(cfg, dtype="float32"), "cuda")
            exact = run(torch.utils._pytree.tree_map(lambda t: t.float(), params))
            model = Model(cfg, "cuda")
        before = flash_attention_cuda.launches + ssd_scan_cuda.launches
        with sharding.use_mesh(mesh):
            got = run(local)
        r = {"k2_k4_launches": flash_attention_cuda.launches + ssd_scan_cuda.launches - before}
        if timed_rank is not None and sharding.mesh_sizes(mesh)["model"] > 1:
            with sharding.use_mesh(mesh):
                r["ms"] = wall_ms(lambda: run(local), 5)
                r["collective_ms"] = collective_ms(lambda: run(local))
            r["collective_share"] = r["collective_ms"] / r["ms"]
            dist.barrier()
            if timed_rank:
                r["no_mesh_ms"] = wall_ms(lambda: run(params), 5)
            dist.barrier()
    return {k: (got[k], want[k], exact[k]) for k in got}, r


def bf16_error(name: str, got, want, exact, vocab: int) -> dict:
    """bf16 logits under tensor parallelism against the layer without a mesh:
    the mesh rounds each rank's partial sum of a row-parallel product to
    bf16 where the layer without one rounds their sum, so the two are a few
    bf16 ulps apart (PERF.md §6) and each is as far from the same
    layer in float32.  Fail unless the mesh's largest and mean error
    against the float32 layer are within 1.25x those of the layer without a
    mesh."""
    errs = [(x[..., :vocab].float() - exact[..., :vocab]).abs() for x in (got, want)]
    r = {"max_err": float(errs[0].max()), "no_mesh_max_err": float(errs[1].max()),
         "mean_err": float(errs[0].mean()), "no_mesh_mean_err": float(errs[1].mean()),
         "max_abs_diff": float((got - want)[..., :vocab].abs().max())}
    if r["max_err"] > 1.25 * r["no_mesh_max_err"] or r["mean_err"] > 1.25 * r["no_mesh_mean_err"]:
        fail(f"{name}: tensor parallel error against float32 {r}")
    return r


def collective_ms(fn) -> float:
    """Wall ms that one call of ``fn`` spends in the tensor-parallel
    collectives (``distributed.collectives``' all-reduces and all-gathers),
    the device synchronised around each."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives

    spent = [0.0]

    class Timed:
        def __getattr__(self, name):
            fn_ = getattr(dist, name)
            if name not in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
                return fn_

            def call(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn_(*a, **kw)
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t
                return out

            return call

    collectives.dist = Timed()
    try:
        fn()
    finally:
        collectives.dist = dist
    return spent[0] * 1e3


DRYRUN_CELLS = {"prefill 4x2048": ("prefill", 2048, 4, 0), "verify 8x5": ("decode", 512, 8, 4),
                "train 4x2048": ("train", 2048, 4, 0)}


def dryrun_phase(report: dict) -> dict:
    """M12 (a): full-width qwen3-1.7b (28 layers, bf16) at DRYRUN_CELLS,
    counted by ``lower_cell`` on meta and run on the card under the same
    analyzer: FLOPs, bytes and kernel calls must be equal, and the argument
    bytes those of the real tensors.  Printed, not gated: the predicted peak
    (temp + output) against ``max_memory_allocated`` over the step, and the
    larger roofline term (H100 data-sheet constants) against the step's
    device ms.  The training step (forward, backward and AdamW; K2's forward
    twice a layer under "minimal" remat, its backward once) must also launch
    as many K2 calls as both count.  Then K1, K2 and K4 at the heads one rank
    holds under a 2-way model axis (qwen3-1.7b's 8 and 4, mamba2-2.7b's 40),
    checked and timed, and for training K2's forward with lse and backward
    and K4's backward there; returns those timings."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun_lib

    res = report["dryrun"] = {}
    t0 = time.perf_counter()
    one = {"data": 1, "model": 1}
    for name, (kind, S, B, spec) in DRYRUN_CELLS.items():
        shape = ShapeConfig(name, kind, S, B)
        meta = dryrun_lib.lower_cell("qwen3-1.7b", name, spec_tokens=spec, shape=shape, sizes=one)
        seen = {}

        def measure(step, seen=seen):
            seen["launches"] = read_counts()  # the analyzed step's
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = step()
            torch.cuda.synchronize()
            seen["peak"] = torch.cuda.max_memory_allocated() - base
            del out
            seen["ms"] = timed(lambda i: step(), 5 if kind != "train" else 3)

        zero_counts()
        card = dryrun_lib.lower_cell("qwen3-1.7b", name, spec_tokens=spec, shape=shape,
                                     sizes=one, device="cuda", after=measure)
        for key in ("flops_per_device", "bytes_per_device", "kernels", "argument_bytes"):
            if getattr(meta, key) != getattr(card, key):
                fail(f"dry run {name}: {key} on meta {getattr(meta, key)} and on the card "
                     f"{getattr(card, key)} differ")
        launched = {k: seen["launches"][k] for k in card.kernels}
        if launched != card.kernels or kind == "train" and launched != {
                "flash_attention": 56, "flash_attention_bwd": 28}:
            fail(f"dry run {name}: launched {launched}, counted {card.kernels}")
        terms = dryrun_lib.roofline_terms(card, one)
        bound = max(terms["compute_s"], terms["memory_s"]) * 1e3
        r = res[name] = {"flops": card.flops_per_device, "bytes": card.bytes_per_device,
                         "kernels": card.kernels, "argument_bytes": card.argument_bytes,
                         "predicted_peak_bytes": card.peak_memory_per_device,
                         "measured_peak_bytes": seen["peak"], "predicted_ms": bound,
                         "bound_by": max(("compute", "memory"),
                                         key=lambda t: terms[t + "_s"]),
                         "ms": seen["ms"], "roofline_share": bound / seen["ms"]}
        print(f"dry run {name}: meta and card agree: {r['flops']:.4e} FLOPs, {r['bytes']:.4e} "
              f"bytes, kernels {r['kernels']}, arguments {r['argument_bytes']} bytes; peak "
              f"predicted {r['predicted_peak_bytes'] / 1e9:.3f} GB, measured "
              f"{r['measured_peak_bytes'] / 1e9:.3f} GB; roofline {bound:.4f} ms "
              f"({r['bound_by']}, data sheet) against {r['ms']:.4f} ms on the card: share "
              f"{r['roofline_share']:.1%}")
        release()
    g = torch.Generator(device="cuda").manual_seed(44)
    timing = {"flash_attention (TP rank, H = 8)": flash_timing(g, 4, 2048, 8, 4, 128),
              "decode_attention (TP rank, H = 8)": decode_timing(g, 8, 5, 512, 8, 4, 128)}
    timing["ssd_scan (TP rank, H = 40)"] = ssd_kernel_phase(report, [], 40, "dryrun_ssd")["train"]
    rows = train_kernel_phase(report, [(4, 2048, 8, 4, 128, "bfloat16", None)],
                              ((" tp", 8, 4),), "mesh_train_kernels", 46)
    timing["flash_attention_bwd (TP training rank, H = 8)"] = rows["bwd tp"]
    timing["flash_attention (TP training rank, H = 8, lse)"] = rows["fwd tp"]
    timing["ssd_scan_bwd (TP training rank, H = 40)"] = ssd_bwd_phase(
        report, [(4, 2048, 40, 64, 1, 128, "bfloat16")], (4, 2048, 40, 64, 1, 128),
        "mesh_ssd_bwd", 47)
    for name, t in timing.items():
        t.setdefault("max_abs_err", t.get("err"))
        if t["library_ms"] is not None:
            show_timing(name, t)
    report["dryrun_s"] = time.perf_counter() - t0
    print(f"dry run: the group took {report['dryrun_s']:.1f} s")
    return timing


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
    report: dict = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "phase_end_s": {}}
    start = time.perf_counter()

    def stamp(name):  # seconds from the start to the end of each group of phases
        report["phase_end_s"][name] = time.perf_counter() - start
        print(f"[{report['phase_end_s'][name]:.1f} s] {name} done", flush=True)

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

    no_spills(report, logs)
    tensor_core_sass(report)
    timing = kernel_phase(report)
    paged_timing = paged_kernel_phase(report)
    model_phase(report)
    chunked_model_phase(report)
    stamp("build, kernels and model checks")
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
    dense_weights = to_cpu(params)  # the front door's phases serve them again, last
    del serve, params, _  # _: the weights twice() returned, the same tensors
    release()
    stamp("qwen3-1.7b serves")
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
    stamp("llama2-7b")
    ssd_timing = ssd_kernel_phase(report)
    mamba_model_phase(report)
    mamba_launches, serve, w = twice(report, "mamba_serve",
                                     lambda g, **w: mamba_serve_phase(report, graphed=g, **w),
                                     profile={"key": "mamba_profile", "seed": 3, "split": True})
    del serve, w  # the mamba2 weights too: the front door's serves measure their peaks
    release()
    stamp("mamba2-2.7b")
    m9_timing = m9_kernel_phase(report)
    release()
    for arch in M9_HEADS:
        model_phase(report, arch)
        release()
    qwen25_launches, serve, w = twice(
        report, "qwen2.5-14b_serve",
        lambda g, **w: serve_phase(report, graphed=g, arch="qwen2.5-14b",
                                   n_layers=QWEN25_SERVE_LAYERS, **w))
    profile_phase(serve, report, key="qwen2.5-14b_profile")
    del serve, w  # its 29.5 GB of weights: the next serves measure their peaks
    release()
    sc_launches, serve = paged_serve_phase(None, report, arch="starcoder2-7b")
    del serve
    release()
    h2o_launches, serve = ring_serve_phase(report, n_layers=H2O_SERVE_LAYERS)
    profile_phase(serve, report, key="h2o_profile", lens=H2O_LENS, seed=14)
    del serve
    release()
    stamp("M9 models")
    moe_timing = moe_kernel_phase(report)
    release()
    for arch, n_layers in (("qwen3-moe-30b-a3b", 2), ("mixtral-8x7b", 1)):
        model_phase(report, arch, n_layers)
        release()
    qmoe_launches, mixtral_launches = moe_phase(report)
    stamp("MoE models")
    encdec_timing = encdec_kernel_phase(report)
    release()
    for arch in ENCDEC_HEADS:
        encdec_model_phase(report, arch)
        release()
    encdec = {}
    for arch in ENCDEC_HEADS:
        encdec[arch] = encdec_phase(report, arch)
        release()
    cross_grad_refused()
    release()
    stamp("encoder-decoder and vision-prefix models")
    jamba_timing = jamba_kernel_phase(report)
    release()
    jamba_model_phase(report)
    release()
    jamba_launches = jamba_phase(report)
    stamp(JAMBA)
    params = to_cpu(dense_weights, "cuda")
    del dense_weights
    gateway_phase(params, report)
    release()
    trace_cost_phase(params, report)
    del params
    release()
    cli_phase(report)
    stamp("front door")
    release()
    example_timing = example_kernel_phase(report)
    release()
    quickstart = quickstart_phase(report)
    release()
    serve_cluster_phase(report)
    release()
    stamp("examples: kernels, quickstart and serve_cluster")
    distributed_phase(report)
    release()
    stamp("distributed")
    dryrun_timing = dryrun_phase(report)
    release()
    stamp("dry run")
    train_timing = train_kernel_phase(report)
    release()
    ssd_bwd_timing = ssd_bwd_phase(report)
    release()
    encdec_train_timing = encdec_bwd_phase(report)
    release()
    stamp("training kernels")
    for arch in TRAIN_RUNS:
        train_model_phase(report, arch)
        release()
    stamp("training model checks")
    train_launches = {}
    for arch in TRAIN_RUNS:
        train_launches[arch] = train_phase(report, arch)
        release()
    train_launches[JAMBA] = train_phase(report, JAMBA, JAMBA_CUTS["train"])
    release()
    stamp("training runs")
    restart_phase(report)
    stamp("training")
    resilient = resilient_phase(report)
    release()
    compressed_phase(report)
    release()
    stamp("examples: train_resilient and compressed training")

    def entry(name, kernel, r, n):  # every number measured in this run, or computed (bound)
        return {"name": name, "kernel": kernel, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name.split()[0]}.cu",
                "replaces": REPLACES[name.split()[0]], "launches": n,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"], "shape": r["shape"]}

    # launches: K1 and K2 from the dense serve, K1 at the chunk shape from the
    # chunked serve's chunk steps, K3 from the paged serve (its decode/verify
    # and admission calls apart, 28 launches a call), K4 from the mamba2
    # serve; at one query head per KV head, K1 from the paper serve's target
    # lanes (verify) and draft lanes (proposals), K2 from both lanes' prefills
    ps_calls = report["paged_serve"]
    k3_admit = paged_launches["decode_attention_paged"] * ps_calls["prefill_calls"] // (
        ps_calls["prefill_calls"] + ps_calls["decode_calls"])
    kernels = [entry("decode_attention", "decode_wgmma_kernel", timing["decode_attention"],
                     launches["decode_attention"]),
               entry("decode_attention (chunk)", "decode_wgmma_kernel",
                     timing["decode_attention (chunk)"],
                     report["chunked_serve"]["chunk_step_k1_launches"]),
               entry("flash_attention", "flash_wgmma_kernel", timing["flash_attention"],
                     launches["flash_attention"]),
               entry("decode_attention_paged", "paged_wgmma_kernel", paged_timing["decode"],
                     paged_launches["decode_attention_paged"] - k3_admit),
               entry("decode_attention_paged (admission)", "paged_wgmma_kernel",
                     paged_timing["admission"], k3_admit),
               entry("ssd_scan", "ssd_wgmma_kernel", ssd_timing["serve"],
                     mamba_launches["ssd_scan"])]
    split = report["paper_serve"]["launch_split"]
    kernels += [entry("decode_attention (llama2 verify)", "decode_wgmma_kernel",
                      llama_timing["decode_attention (llama2 verify)"],
                      split["decode_attention.target"]),
                entry("decode_attention (llama2 draft)", "decode_wgmma_kernel",
                      llama_timing["decode_attention (llama2 draft)"],
                      split["decode_attention.draft"]),
                entry("flash_attention (llama2)", "flash_wgmma_kernel",
                      llama_timing["flash_attention (llama2)"],
                      paper_launches["flash_attention"])]
    # the M9 models: K1 and K2 from the qwen2.5 and h2o serves, K3 from the
    # starcoder2 paged serve (decode/verify and admission apart)
    sc = report["starcoder2-7b_paged_serve"]
    sc_admit = sc_launches["decode_attention_paged"] * sc["prefill_calls"] // (
        sc["prefill_calls"] + sc["decode_calls"])
    for name, kernel, n in (
            ("decode_attention (qwen2.5 verify)", "decode_wgmma_kernel",
             qwen25_launches["decode_attention"]),
            ("flash_attention (qwen2.5)", "flash_wgmma_kernel", qwen25_launches["flash_attention"]),
            ("decode_attention_paged (starcoder2 decode)", "paged_wgmma_kernel",
             sc_launches["decode_attention_paged"] - sc_admit),
            ("decode_attention_paged (starcoder2 admission)", "paged_wgmma_kernel", sc_admit),
            ("decode_attention (h2o verify)", "decode_wgmma_kernel",
             h2o_launches["decode_attention"]),
            ("flash_attention (h2o)", "flash_wgmma_kernel", h2o_launches["flash_attention"])):
        kernels.append(entry(name, kernel, m9_timing[name], n))
    # the MoE models: K1 and K2 from the qwen3-moe and mixtral serves
    for name, n in (("decode_attention (qwen3-moe verify)", qmoe_launches["decode_attention"]),
                    ("flash_attention (qwen3-moe)", qmoe_launches["flash_attention"]),
                    ("decode_attention (mixtral verify)", mixtral_launches["decode_attention"]),
                    ("flash_attention (mixtral)", mixtral_launches["flash_attention"])):
        kernel = "decode_wgmma_kernel" if name.startswith("decode") else "flash_wgmma_kernel"
        kernels.append(entry(name, kernel, moe_timing[name], n))
    # the encoder-decoder and the vision-prefix model: each call's launches
    # from its full-depth run (a prefill, then 32 decode steps), by mask
    sm, iv = encdec["seamless-m4t-large-v2"], encdec["internvl2-1b"]
    for name, n in (
            ("flash_attention (seamless encoder)", sm["pre_calls"]["flash_attention.not_causal"]),
            ("flash_attention (seamless decoder prefill)",
             sm["pre_calls"]["flash_attention.causal"]),
            ("decode_attention (seamless cross prefill)",
             sm["pre_calls"]["decode_attention.not_causal"]),
            ("decode_attention (seamless cross decode)",
             sm["step_calls"]["decode_attention.not_causal"]),
            ("decode_attention (seamless self decode)",
             sm["step_calls"]["decode_attention.causal"]),
            ("flash_attention (internvl2 prefill)", iv["pre_calls"]["flash_attention.causal"]),
            ("decode_attention (internvl2 decode)", iv["step_calls"]["decode_attention.causal"])):
        kernel = "decode_wgmma_kernel" if name.startswith("decode") else "flash_wgmma_kernel"
        kernels.append(entry(name, kernel, encdec_timing[name], n))
    # training: K2 backward and forward (with lse) launches from the qwen3 and
    # qwen3-moe runs, K4 backward and forward from the mamba2 run
    tq, tm, tmoe = (train_launches[a] for a in ("qwen3-1.7b", "mamba2-2.7b", "qwen3-moe-30b-a3b"))
    kernels += [entry("flash_attention_bwd (qwen3 training)", "dkdv_wgmma_kernel, dq_wgmma_kernel",
                      train_timing["bwd"], tq["flash_attention_bwd"]),
                entry("flash_attention (qwen3 training, lse)", "flash_wgmma_kernel",
                      train_timing["fwd"], tq["flash_attention"]),
                entry("ssd_scan_bwd (mamba2 training)",
                      "ssd_bwd_wgmma_kernel, ssd_bwd_reduce4_kernel", ssd_bwd_timing,
                      tm["ssd_scan_bwd"]),
                entry("ssd_scan (mamba2 training)", "ssd_wgmma_kernel", ssd_timing["train"],
                      tm["ssd_scan"]),
                entry("flash_attention_bwd (qwen3-moe training, G = 8)",
                      "dkdv_wgmma_kernel, dq_wgmma_kernel", train_timing["bwd g8"],
                      tmoe["flash_attention_bwd"]),
                entry("flash_attention (qwen3-moe training, lse)", "flash_wgmma_kernel",
                      train_timing["fwd g8"], tmoe["flash_attention"])]
    # the encoder-decoder's and the vision-prefix model's training: K2's
    # launches at each shape of their runs (k2_by_shape), K2's shapes alone
    # timed in encdec_bwd_phase
    for arch, name in (("seamless-m4t-large-v2", "seamless cross"),
                       ("seamless-m4t-large-v2", "seamless encoder"),
                       ("seamless-m4t-large-v2", "seamless decoder"),
                       ("internvl2-1b", "internvl2")):
        _, Sq, Sk, *_, causal = ENCDEC_BWD[name]
        at = f"{Sq}x{Sk} {'' if causal else 'not '}causal"
        kernels += [entry(f"flash_attention_bwd ({name} training)",
                          "dkdv_wgmma_kernel, dq_wgmma_kernel", encdec_train_timing["bwd " + name],
                          train_launches[arch][f"flash_attention_bwd {at}"]),
                    entry(f"flash_attention ({name} training, lse)", "flash_wgmma_kernel",
                          encdec_train_timing["fwd " + name],
                          train_launches[arch][f"flash_attention {at}"])]
    # jamba: K1, K2 and K4 from the graphed serve of layers 4-7, the backward
    # passes and the forwards with lse or at the training shape from its
    # training run on layers 6-7
    tj = train_launches[JAMBA]
    for name, kernel, n in (
            ("decode_attention (jamba verify)", "decode_wgmma_kernel",
             jamba_launches["decode_attention"]),
            ("flash_attention (jamba prefill)", "flash_wgmma_kernel",
             jamba_launches["flash_attention"]),
            ("ssd_scan (jamba prefill)", "ssd_wgmma_kernel", jamba_launches["ssd_scan"]),
            ("flash_attention_bwd (jamba training)", "dkdv_wgmma_kernel, dq_wgmma_kernel",
             tj["flash_attention_bwd"]),
            ("flash_attention (jamba training, lse)", "flash_wgmma_kernel", tj["flash_attention"]),
            ("ssd_scan_bwd (jamba training)", "ssd_bwd_wgmma_kernel, ssd_bwd_reduce4_kernel",
             tj["ssd_scan_bwd"]),
            ("ssd_scan (jamba training)", "ssd_wgmma_kernel", tj["ssd_scan"])):
        kernels.append(entry(name, kernel, jamba_timing[name], n))
    # the examples: K1 and K2's prefill from the quickstart's serve, K2's
    # training calls from its training, K4 from train_resilient's four runs
    for name, kernel, n in (
            ("decode_attention (quickstart serve)", "decode_wgmma_kernel",
             quickstart["serve"]["decode_attention"]),
            ("flash_attention (quickstart prefill)", "flash_wgmma_kernel",
             quickstart["serve"]["flash_attention"]),
            ("flash_attention (quickstart training, lse)", "flash_wgmma_kernel",
             quickstart["train"]["flash_attention"]),
            ("flash_attention_bwd (quickstart training)", "dkdv_wgmma_kernel, dq_wgmma_kernel",
             quickstart["train"]["flash_attention_bwd"]),
            ("ssd_scan (train_resilient)", "ssd_wgmma_kernel", resilient["ssd_scan"]),
            ("ssd_scan_bwd (train_resilient)", "ssd_bwd_wgmma_kernel, ssd_bwd_reduce4_kernel",
             resilient["ssd_scan_bwd"])):
        kernels.append(entry(name, kernel, example_timing[name], n))
    # M12: K2 and K4 at a rank's heads from the tensor-parallel layers' runs
    # (rank 0 of phase 16 (b), bf16 and fp32)
    tp = {arch: sum(report["distributed"][f"(b) TP {arch} {dt}"]["k2_k4_launches"]
                    for dt in ("bfloat16", "float32")) for arch in TP_ARCHS}
    for name, kernel, n in (
            ("flash_attention (TP rank, H = 8)", "flash_wgmma_kernel", tp["qwen3-1.7b"]),
            ("ssd_scan (TP rank, H = 40)", "ssd_wgmma_kernel", tp["mamba2-2.7b"])):
        kernels.append(entry(name, kernel, dryrun_timing[name], n))
    # training under a mesh: K2 and K4 at a rank's heads from (b)'s model=2
    # steps (rank 0, fp32 and bf16); K4's forward at 40 heads is the row above
    mt = {arch: {k: sum(report["distributed"][f"(b) train {arch} model=2 {dt}"][k + "_launches"]
                        for dt in ("bfloat16", "float32")) for k in MESH_TRAIN_KERNELS}
          for arch in ("qwen3", "mamba2")}
    for name, kernel, n in (
            ("flash_attention (TP training rank, H = 8, lse)", "flash_wgmma_kernel",
             mt["qwen3"]["flash_attention"]),
            ("flash_attention_bwd (TP training rank, H = 8)", "dkdv_wgmma_kernel, dq_wgmma_kernel",
             mt["qwen3"]["flash_attention_bwd"]),
            ("ssd_scan (TP training rank, H = 40)", "ssd_wgmma_kernel", mt["mamba2"]["ssd_scan"]),
            ("ssd_scan_bwd (TP training rank, H = 40)", "ssd_bwd_wgmma_kernel, "
             "ssd_bwd_reduce4_kernel", mt["mamba2"]["ssd_scan_bwd"])):
        kernels.append(entry(name, kernel, dryrun_timing[name.replace("training ", "")
                                                         if name.startswith("ssd_scan (")
                                                         else name], n))
    # resilient training under a mesh: K2 and K4 at a rank's heads from (b)'s
    # compressed steps at model = 2 (rank 0, fp32 and bf16), at the shapes of
    # the rows above
    ct = {arch: {k: sum(report["distributed"][f"(b) compressed {arch} model=2 {dt}"][
        k + "_launches"] for dt in ("bfloat16", "float32")) for k in MESH_TRAIN_KERNELS}
          for arch in ("qwen3", "mamba2")}
    for name, kernel, n, timed_as in (
            ("flash_attention (compressed TP training rank, H = 8, lse)", "flash_wgmma_kernel",
             ct["qwen3"]["flash_attention"], "flash_attention (TP training rank, H = 8, lse)"),
            ("flash_attention_bwd (compressed TP training rank, H = 8)",
             "dkdv_wgmma_kernel, dq_wgmma_kernel", ct["qwen3"]["flash_attention_bwd"],
             "flash_attention_bwd (TP training rank, H = 8)"),
            ("ssd_scan (compressed TP training rank, H = 40)", "ssd_wgmma_kernel",
             ct["mamba2"]["ssd_scan"], "ssd_scan (TP rank, H = 40)"),
            ("ssd_scan_bwd (compressed TP training rank, H = 40)", "ssd_bwd_wgmma_kernel, "
             "ssd_bwd_reduce4_kernel", ct["mamba2"]["ssd_scan_bwd"],
             "ssd_scan_bwd (TP training rank, H = 40)")):
        kernels.append(entry(name, kernel, dryrun_timing[timed_as], n))
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
    if sys.argv[1:2] == ["--distributed-rank"]:  # one of distributed_phase's two ranks
        distributed_rank(int(sys.argv[2]), sys.argv[3])
    else:
        main()
