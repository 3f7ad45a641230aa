"""Quickstart on the PyTorch port: train a small model, then serve it through
the whole StreamServe stack (FlowGuard routing, SpecuStream adaptive
speculation, disaggregated stream pairs) through the public API.  On an
NVIDIA GPU by default; ``--device cpu`` runs the plain versions of the
kernels on the CPU.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.api import ServeConfig, StreamServe
from repro_torch.data.workloads import TokenStream
from repro_torch.models import build_model
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import make_train_step


def main(steps=80, device="cuda"):
    # ---- 1. one config for the whole stack ---------------------------------
    cfg = ServeConfig.reduced_smoke("qwen3-1.7b")
    arch = cfg.build_arch_config()
    model = build_model(arch, device)
    params = model.init(0)
    print(f"model: {arch.name} (reduced) on {model.device}: {arch.n_params() / 1e6:.2f}M params")

    # ---- 2. train it briefly ------------------------------------------------
    init_opt, train_step = make_train_step(
        model, OptConfig(learning_rate=3e-3, warmup_steps=5, total_steps=steps))
    opt = init_opt(params)
    stream = TokenStream(arch.vocab_size, 32, 8, seed=0)
    t0 = time.perf_counter()
    losses = []
    for step in range(steps):
        stream.step = step
        batch = {"tokens": torch.from_numpy(next(stream)).to(model.device)}
        params, opt, metrics = train_step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if step % 20 == 0:
            print(f"  train step {step:3d}  loss {losses[-1]:.4f}")
    train_s = time.perf_counter() - t0
    print(f"trained {steps} steps in {train_s:.1f}s: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training must reduce loss"

    # ---- 3. serve the trained params through the StreamServe API -----------
    t0 = time.perf_counter()
    serve = StreamServe(cfg, params=params, device=model.device)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, arch.vocab_size, 8).tolist()  # a common prefix
    handles = [serve.submit(shared + rng.integers(0, arch.vocab_size, 8).tolist())
               for _ in range(6)]
    # stream the first request token by token (this drives the shared engine,
    # so the other five decode beside it in the same batch)
    streamed = list(handles[0].stream())
    print(f"\n{handles[0].request_id} streamed {len(streamed)} tokens: {streamed[:6]}...")
    for h in handles[1:]:
        h.result()
    serve_s = time.perf_counter() - t0
    assert all(h.done for h in handles) and streamed == handles[0].result()
    s = serve.summary()
    print(f"served {int(s['n'])} requests in {serve_s:.1f}s")
    for h in handles[:3]:
        slo = h.slo()
        print(f"  {h.request_id} -> worker {slo['worker_id']}, "
              f"{slo['n_tokens']} tokens, ttft {slo['ttft']:.0f} ticks")
    for w in serve.worker_stats():
        print(f"  pair {w['worker_id']}: acceptance {w['acceptance']:.2f}, "
              f"spec depth {w['spec_depth'] or '-'}, cache hit {w['cache_hit_rate']:.2f}")
    print("OK")
    return {"losses": losses, "train_s": train_s, "serve_s": serve_s, "summary": s,
            "tokens": [h.result() for h in handles]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.steps, args.device)
