"""Serving driver: the StreamServe stack on the PyTorch engine (a port of
``repro.launch.serve``).  Requests are submitted at tick 0 and stream
tokens until every one has finished.

  python -m repro_torch.launch.serve --device cpu --requests 6 --max-new 8
  python -m repro_torch.launch.serve --no-reduced     # full width, on the card
  python -m repro_torch.launch.serve --arch mamba2-2.7b --device cpu --requests 6
  python -m repro_torch.launch.serve --arch mamba2-2.7b --no-reduced   # on the card
  # the paper's model with the small-transformer draft, round-robin routing
  python -m repro_torch.launch.serve --arch llama2-7b --reduced --draft model \
      --router roundrobin --device cpu --requests 6

The reference's ``--config``/``--dump-config`` (YAML), ``--trace*``, HTTP
gateway and fault-injection flags wait for those features (ROADMAP).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

# flag -> ServeConfig field (default=SUPPRESS: only typed flags override)
_CONFIG_FLAGS = {"arch": "arch", "reduced": "reduced", "pairs": "n_pairs",
                 "max_batch": "max_batch", "max_len": "max_len", "max_new": "max_new_tokens",
                 "router": "router", "draft": "draft", "spec_policy": "spec_policy",
                 "fixed_depth": "fixed_depth", "seed": "seed"}
# CLI defaults for a quick run
_CLI_BASE = {"max_batch": 4, "max_len": 192, "max_new_tokens": 24}


def main(argv=None):
    ap = argparse.ArgumentParser()
    S = argparse.SUPPRESS
    for flag, kind in (("--arch", str), ("--pairs", int), ("--max-batch", int),
                       ("--max-len", int), ("--max-new", int), ("--router", str),
                       ("--draft", str), ("--spec-policy", str), ("--fixed-depth", int),
                       ("--seed", int)):
        ap.add_argument(flag, type=kind, default=S)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=S,
                    help="reduced CPU-sized model (--no-reduced: full width)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--warmup", action="store_true", help="run every shape bucket first")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.api import ServeConfig, StreamServe

    overrides = {f: getattr(args, a) for a, f in _CONFIG_FLAGS.items() if hasattr(args, a)}
    cfg = ServeConfig(**_CLI_BASE).replace(**overrides)
    serve = StreamServe(cfg, device=args.device)
    if args.warmup:
        serve.engine.warmup()
    rng = np.random.default_rng(cfg.seed)
    shared = rng.integers(0, serve.arch.vocab_size, 8).tolist()  # engages the prefix signal
    t0 = time.perf_counter()
    handles = [serve.submit(shared + rng.integers(0, serve.arch.vocab_size,
                                                  args.prompt_len - 8).tolist())
               for _ in range(args.requests)]
    serve.run_until_done(max_steps=5000)
    wall = time.perf_counter() - t0
    s = serve.summary()
    done = sum(h.state.value == "finished" for h in handles)
    print(f"completed {done}/{args.requests} requests in {wall:.2f}s wall "
          f"({serve.engine._now:.0f} steps) on {serve.device}")
    print(f"latency mean={s['latency_mean']:.1f} p99={s['latency_p99']:.1f} ticks, "
          f"ttft mean={s['ttft_mean']:.2f}, tpot mean={s['tpot_mean']:.2f} ticks")
    for pair in serve.engine.pairs:
        served = sum(r.worker_id == pair.worker_id for r in serve.monitor.completed)
        print(f"  pair {pair.worker_id}: healthy={pair.healthy} "
              f"acceptance={pair.acceptance:.2f} cache_hit={pair.kv.hit_rate:.2f} "
              f"served={served}")
    return {"summary": s, "serve": serve, "config": cfg}


if __name__ == "__main__":
    main()
