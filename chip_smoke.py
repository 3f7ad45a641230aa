"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each fatal on failure:
  1. print the card (nvidia-smi name and power limit) and versions; build the
     CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
     all at once);
  2. hold each kernel against its plain PyTorch version at the serving
     shapes (bf16, plus fp32, stale-slot poisoning and a fully masked row),
     and time kernel, plain version and ``scaled_dot_product_attention``;
  3. check the full-width model on the card against the same weights on the
     CPU (2 layers, float32);
  4. serve qwen3-1.7b at full width (28 layers, d_model 2048) with 2 stream
     pairs through ``StreamServe``, counting kernel launches;
  5. time a burst of 8 requests, then profile the same burst (device busy
     share of the wall, device time by kernel);
  6. print the kernel table as one JSON line, then the result line.
Without CUDA, or outside a checkout, it exits non-zero and prints no result.
Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                                 # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}         # dense, per type
TOL = {"bfloat16": 2e-2, "float32": 2e-5}                 # tests/test_kernels.py:19
REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention.py:113",
    "flash_attention": "src/repro/kernels/flash_attention.py:131",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def timed(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def check(name: str, got, want, dt: str) -> float:
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err = max_err(got, want)
    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    if not bool((diff <= TOL[dt] + TOL[dt] * ref).all()):  # atol = rtol = TOL
        fail(f"{name}: kernel and plain version differ (max abs {err:.3g}, tol {TOL[dt]})")
    return err


# ------------------------------------------------------------------ kernels

def decode_case(g, B, T, S, H, K, D, dt, fill, poison=True):
    """Decode inputs as the serving path makes them: row b holds fill[b]
    committed positions, the T new tokens written after them, and stale
    speculative slots (positions past the horizon) poisoned."""
    import torch

    dev, dtype = "cuda", getattr(torch, dt)
    q = torch.randn(B, T, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, K, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, K, D, generator=g, device=dev).to(dtype)
    clen = torch.tensor([min(f + T, S) for f in fill], dtype=torch.int32, device=dev)
    pos = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    for b, L in enumerate(clen.tolist()):
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
    # ---- decode: every verify bucket, bf16; fp32; a fully masked row -------
    fills = [20, 60, 140, 200, 290, 350, 420, 490]
    for T, dt in [(1, "bfloat16"), (2, "bfloat16"), (3, "bfloat16"), (5, "bfloat16"),
                  (9, "bfloat16"), (5, "float32")]:
        q, k, v, clen, pos = decode_case(g, 8, T, S, H, K, D, dt, fills)
        got = decode_attention_cuda(q, k, v, clen, kv_positions=pos)
        want = ref.decode_attention(q, k, v, clen, kv_positions=pos)
        e = check(f"decode T={T} {dt}", got, want, dt)
        errs["decode_attention"] = max(errs["decode_attention"], e) if dt == "bfloat16" \
            else errs["decode_attention"]
        lines.append(f"decode_attention B=8 T={T} S={S} {dt}: max_abs_err={e:.3g}")
    q, k, v, clen, pos = decode_case(g, 8, 3, S, H, K, D, "bfloat16", fills)
    pos[2] = -1  # an idle slot: every position empty
    e = check("decode fully masked row", decode_attention_cuda(q, k, v, clen, kv_positions=pos),
              ref.decode_attention(q, k, v, clen, kv_positions=pos), "bfloat16")
    lines.append(f"decode_attention fully masked row: finite, max_abs_err={e:.3g}")
    # ---- flash: the prefill buckets, bf16; fp32; window + q_offset ---------
    for B, Sq, dt, kw in [(4, 512, "bfloat16", {}), (2, 256, "bfloat16", {}),
                          (4, 64, "bfloat16", {}), (1, 16, "bfloat16", {}),
                          (2, 256, "float32", {}),
                          (1, 64, "bfloat16", {"q_offset": 192, "window": 100})]:
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

    # ---- timing at the main path's shapes ----------------------------------
    out = {}
    T = 5  # a verify step at the depth-4 bucket; the cache is full
    make = lambda: decode_case(g, 8, T, S, H, K, D, "bfloat16", [S - T] * 8, poison=False)  # noqa: E731
    sets = copies(make, 2 * 8 * S * K * D * 2)
    q, k, v, clen, pos = sets[0]
    nbytes, ops = decode_cost(q, k, clen, pos)
    lib = [sdpa_decode(*s) for s in sets]
    out["decode_attention"] = {
        "shape": f"B=8 T={T} S={S} H={H} K={K} D={D} bf16",
        "ms": timed(lambda i: decode_attention_cuda(*sets[i % len(sets)][:4],
                                                    kv_positions=sets[i % len(sets)][4]), 200),
        "plain_ms": timed(lambda i: ref.decode_attention(*sets[i % len(sets)][:4],
                                                         kv_positions=sets[i % len(sets)][4]), 20),
        "library_ms": timed(lambda i: lib[i % len(lib)](), 50),
        "bound": bound_ms(nbytes, ops, "bfloat16"),
    }
    B, Sq = 4, 512
    fsets = copies(lambda: tuple(torch.randn(B, Sq, h, D, generator=g, device="cuda")
                                 .to(torch.bfloat16) for h in (H, K, K)),
                   2 * B * Sq * (H + 2 * K) * D)
    nbytes, ops = flash_cost(fsets[0][0], fsets[0][1])
    tsets = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in fsets]
    out["flash_attention"] = {
        "shape": f"B={B} Sq=Sk={Sq} H={H} K={K} D={D} causal bf16",
        "ms": timed(lambda i: flash_attention_cuda(*fsets[i % len(fsets)]), 50),
        "plain_ms": timed(lambda i: ref.flash_attention(*fsets[i % len(fsets)]), 10),
        "library_ms": timed(lambda i: sdpa(*tsets[i % len(tsets)], is_causal=True), 50),
        "bound": bound_ms(nbytes, ops, "bfloat16"),
    }
    for name, r in out.items():
        r["max_abs_err"] = errs[name]
        print(f"{name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"sdpa {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    report["kernel_checks"] = lines
    return out


# -------------------------------------------------------------------- model

def model_phase(report: dict) -> None:
    """The full-width model's first 2 layers on the card (CUDA kernels) against
    the same weights on the CPU (plain versions), float32: prefill of a
    bucketed batch, a 5-token verify step, a rewind and a plain step."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen3-1.7b"), n_layers=2, dtype="float32")
    gpu = build_model(cfg, "cuda")
    params = gpu.init(1)
    cpu_params = {"embedding": {k: v.cpu() for k, v in params["embedding"].items()},
                  "final_norm": params["final_norm"].cpu(),
                  "layers": [{k: ({kk: vv.cpu() for kk, vv in v.items()}
                                  if isinstance(v, dict) else v.cpu())
                              for k, v in layer.items()} for layer in params["layers"]]}
    cpu = build_model(cfg, "cpu")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, dtype=torch.int32)
    lengths = torch.tensor([64, 37], dtype=torch.int32)
    errs = []
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
    print(f"model check (2 full-width layers, fp32, card vs CPU): max_abs_err={max(errs):.3g}")
    if max(errs) > 1e-3:
        fail(f"model check: logits differ by {max(errs):.3g} > 1e-3")
    report["model_check_max_abs_err"] = max(errs)


# -------------------------------------------------------------------- serve

def serve_phase(report: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.api import ServeConfig, StreamServe
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    cfg = ServeConfig(reduced=False, n_pairs=2, max_batch=8, max_len=512, max_new_tokens=32)
    t0 = time.perf_counter()
    serve = StreamServe(cfg, device="cuda")
    torch.cuda.synchronize()
    arch = serve.arch
    print(f"serve: {arch.name} L={arch.n_layers} d_model={arch.d_model} vocab={arch.vocab_size} "
          f"{arch.dtype}, {cfg.n_pairs} pairs x {cfg.max_batch} slots, max_len {cfg.max_len}; "
          f"init {time.perf_counter() - t0:.2f} s")
    bad = torch.zeros((), dtype=torch.int64, device="cuda")  # non-finite logits seen
    for pair in serve.engine.pairs:
        lane = pair.lane

        def decode(tokens, _f=lane.decode):
            logits = _f(tokens)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits

        def prefill(batch, _f=lane.prefill):
            logits, cache = _f(batch)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, cache

        lane.decode, lane.prefill = decode, prefill
        lane.calls = {"prefill": 0, "decode": 0}
    rng = np.random.default_rng(0)
    lens = [16, 400, 24, 300, 40, 200, 64, 130, 350, 33, 100, 250]
    decode_attention_cuda.launches = 0
    flash_attention_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    handles, submitted, tick_wall = [], {}, {0.0: t_start}
    for n in lens[:8]:
        handles.append(serve.submit(rng.integers(0, arch.vocab_size, n).tolist()))
        submitted[handles[-1].request_id] = time.perf_counter()
    steps = 0
    while serve.pending:
        serve.step()
        steps += 1
        tick_wall[serve.engine._now] = time.perf_counter()
        if steps == 3:  # a second wave joins mid-decode
            for n in lens[8:]:
                handles.append(serve.submit(rng.integers(0, arch.vocab_size, n).tolist()))
                submitted[handles[-1].request_id] = time.perf_counter()
        if steps > 2000:
            fail("serve: the engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {"decode_attention": decode_attention_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    calls = {k: sum(p.lane.calls[k] for p in serve.engine.pairs) for k in ("prefill", "decode")}
    for h in handles:
        toks = h.request.output_tokens
        if h.state.value != "finished" or len(toks) != cfg.max_new_tokens:
            fail(f"serve: {h.request_id} ended {h.state.value} with {len(toks)} tokens")
        if not all(0 <= t < arch.vocab_size for t in toks):
            fail(f"serve: {h.request_id} emitted a token outside the vocabulary")
    if int(bad):
        fail(f"serve: {int(bad)} non-finite logits")
    L = arch.n_layers
    if launches["flash_attention"] != L * calls["prefill"] or calls["prefill"] == 0:
        fail(f"serve: flash launches {launches['flash_attention']} != {L} x "
             f"{calls['prefill']} prefill calls")
    if launches["decode_attention"] != L * calls["decode"] or calls["decode"] == 0:
        fail(f"serve: decode launches {launches['decode_attention']} != {L} x "
             f"{calls['decode']} decode calls")
    recs = serve.monitor.completed
    ttft_s = [tick_wall[r.token_times[0]] - submitted[r.request_id] for r in recs]
    tpot_s = [(tick_wall[r.token_times[-1]] - tick_wall[r.token_times[0]])
              / (len(r.token_times) - 1) for r in recs]
    s = serve.summary()
    generated = sum(r.generated for r in recs)
    result = {
        "requests": len(recs), "prompt_lens": lens, "engine_steps": steps,
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
    print(f"serve: {len(recs)} requests, {generated} tokens in {wall:.3f} s wall "
          f"({generated / wall:.1f} tokens/s), {steps} engine steps "
          f"({wall / steps * 1e3:.1f} ms/step); prefill calls {calls['prefill']}, "
          f"decode calls {calls['decode']}; launches {launches}")
    print(f"serve: TTFT mean {result['ttft_ticks_mean']:.2f} ticks = "
          f"{result['ttft_s_mean']:.3f} s, TPOT mean {result['tpot_ticks_mean']:.3f} ticks = "
          f"{result['tpot_s_mean'] * 1e3:.2f} ms; peak memory {result['peak_mem_gb']:.2f} GB")
    report["serve"] = result
    return launches, serve


def profile_phase(serve, report: dict) -> None:
    """Where the time goes.  The same burst of 8 requests runs twice through
    the same server (after the launch counts were read): once plain, timed
    on the host clock, and once under torch.profiler recording CUDA activity
    only.  Device busy time is the sum of kernel and copy durations on the
    one stream; the busy share is that over the plain burst's wall time
    (greedy decoding does the same device work both times)."""
    from collections import Counter

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def burst():
        rng = np.random.default_rng(1)
        for n in (16, 400, 24, 300, 40, 200, 64, 130):
            serve.submit(rng.integers(0, serve.arch.vocab_size, n).tolist())
        t0 = time.perf_counter()
        serve.run_until_done()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = burst()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_profiled = burst()
    by_name: Counter = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    groups = (("decode_kernel", "decode_attention"), ("flash_kernel", "flash_attention"),
              ("gemm", "matmul"), ("nvjet", "matmul"), ("xmma", "matmul"),
              ("cutlass", "matmul"), ("memcpy", "copies"), ("memset", "copies"))
    by_group: Counter = Counter()
    for name, ms in by_name.items():
        by_group[next((g for key, g in groups if key in name.lower()), "other")] += ms
    busy = sum(by_group.values())
    report["profile"] = {
        "burst_wall_ms": wall * 1e3, "burst_wall_profiled_ms": wall_profiled * 1e3,
        "device_busy_ms": busy, "busy_share": busy / (wall * 1e3),
        "device_ms_by_group": dict(by_group.most_common()),
        "top_kernels_ms": dict(by_name.most_common(12))}
    if not busy:
        fail("profile: the profiler recorded no device events")
    print(f"profile: burst of 8 requests {wall * 1e3:.1f} ms wall ({wall_profiled * 1e3:.1f} ms "
          f"profiled), device busy {busy:.1f} ms = {busy / (wall * 1e3):.1%} of the wall")
    print("profile: device time " + ", ".join(
        f"{g} {ms / busy:.1%}" for g, ms in by_group.most_common()))
    for name, ms in by_name.most_common(6):
        print(f"  {ms:9.2f} ms  {name[:110]}")


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

    timing = kernel_phase(report)
    model_phase(report)
    launches, serve = serve_phase(report)
    profile_phase(serve, report)
    kernels = []
    for name, r in timing.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": r["shape"],
        })
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
