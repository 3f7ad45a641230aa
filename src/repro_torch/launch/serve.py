"""Serving driver: the StreamServe stack on the PyTorch engine (a port of
``repro.launch.serve``).  Requests are submitted at tick 0 and stream tokens
until every one has ended; a worker can be killed (at step 5) or a request
cancelled (at step 3) mid-run.  ``--http`` serves the gateway instead.

  python -m repro_torch.launch.serve --device cpu --requests 6 --max-new 8
  python -m repro_torch.launch.serve --device cpu --requests 6 --cancel-one \
      --fail-worker 1 --trace-out trace.json
  python -m repro_torch.launch.serve --no-reduced     # full width, on the card
  python -m repro_torch.launch.serve --arch mamba2-2.7b --device cpu --requests 6
  python -m repro_torch.launch.serve --arch mamba2-2.7b --no-reduced   # on the card
  python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --device cpu --requests 6
  # the paper's model with the small-transformer draft, round-robin routing
  python -m repro_torch.launch.serve --arch llama2-7b --reduced --draft model \
      --router roundrobin --device cpu --requests 6
  python -m repro_torch.launch.serve --config serve.yaml   # typed flags override the file
  python -m repro_torch.launch.serve --dump-config serve.yaml   # write it and exit
  python -m repro_torch.launch.serve --device cpu --http --port 0   # HTTP/SSE gateway
  python -m repro_torch.launch.serve --no-reduced --warmup --http   # on the card
"""
from __future__ import annotations

import argparse
import time

import numpy as np

# flag -> ServeConfig field (default=SUPPRESS: only typed flags override --config)
_CONFIG_FLAGS = {"arch": "arch", "reduced": "reduced", "pairs": "n_pairs",
                 "max_batch": "max_batch", "max_len": "max_len", "max_new": "max_new_tokens",
                 "router": "router", "draft": "draft", "spec_policy": "spec_policy",
                 "fixed_depth": "fixed_depth", "seed": "seed", "trace": "trace",
                 "trace_dir": "trace_dir", "host": "gateway_host", "port": "gateway_port",
                 "max_pending": "gateway_max_pending"}
# CLI defaults for a quick run (applied only without --config)
_CLI_BASE = {"max_batch": 4, "max_len": 192, "max_new_tokens": 24}


def main(argv=None):
    ap = argparse.ArgumentParser()
    S = argparse.SUPPRESS
    for flag, kind in (("--arch", str), ("--pairs", int), ("--max-batch", int),
                       ("--max-len", int), ("--max-new", int), ("--router", str),
                       ("--draft", str), ("--spec-policy", str), ("--fixed-depth", int),
                       ("--seed", int), ("--trace-dir", str), ("--host", str), ("--port", int),
                       ("--max-pending", int)):
        ap.add_argument(flag, type=kind, default=S)
    ap.add_argument("--trace", default=S, choices=("off", "on", "flight"))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=S,
                    help="reduced CPU-sized model (--no-reduced: full width)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--config", default=None, help="a ServeConfig YAML (typed flags override it)")
    ap.add_argument("--dump-config", default=None, help="write the resolved YAML and exit")
    ap.add_argument("--fail-worker", type=int, default=-1, help="kill this pair at step 5")
    ap.add_argument("--cancel-one", action="store_true",
                    help="cancel the last submitted request at step 3")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace here after the run (implies --trace on)")
    ap.add_argument("--http", action="store_true", help="serve the HTTP/SSE gateway")
    ap.add_argument("--warmup", action="store_true",
                    help="run every shape bucket first (on the card: capture every graph)")
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.trace_out and not hasattr(args, "trace"):
        args.trace = "on"

    from repro_torch.api import ServeConfig, StreamServe

    base = ServeConfig.from_yaml(args.config) if args.config else ServeConfig(**_CLI_BASE)
    cfg = base.replace(**{f: getattr(args, a) for a, f in _CONFIG_FLAGS.items()
                          if hasattr(args, a)})
    if args.dump_config:
        cfg.to_yaml(args.dump_config)
        print(f"wrote {args.dump_config}")
        return {"config": cfg}
    serve = StreamServe(cfg, device=args.device)
    if args.warmup:
        serve.engine.warmup()
    if args.http:
        from repro_torch.gateway import run_gateway

        run_gateway(serve, host=cfg.gateway_host, port=cfg.gateway_port)
        return {"config": cfg, "serve": serve}
    rng = np.random.default_rng(cfg.seed)
    shared = rng.integers(0, serve.arch.vocab_size, 8).tolist()  # engages the prefix signal
    t0 = time.perf_counter()
    handles = [serve.submit(shared + rng.integers(0, serve.arch.vocab_size,
                                                  args.prompt_len - 8).tolist())
               for _ in range(args.requests)]
    steps = 0
    while serve.pending > 0:
        serve.step()
        steps += 1
        if steps == 5 and args.fail_worker >= 0:
            n = serve.fail_worker(args.fail_worker)
            print(f"!! killed stream pair {args.fail_worker}; re-routed {n} requests")
        if steps == 3 and args.cancel_one:
            handles[-1].cancel()
            print(f"!! cancelled {handles[-1].request_id} mid-run")
        if steps > 5000:
            raise RuntimeError("engine did not drain")
    wall = time.perf_counter() - t0
    s = serve.summary()
    done = sum(h.state.value == "finished" for h in handles)
    print(f"completed {done}/{args.requests} requests in {wall:.2f}s wall "
          f"({steps} steps) on {serve.device}")
    print(f"latency mean={s['latency_mean']:.1f} p99={s['latency_p99']:.1f} ticks, "
          f"ttft mean={s['ttft_mean']:.2f}, tpot mean={s['tpot_mean']:.2f} ticks")
    for w in serve.worker_stats():
        served = sum(r.worker_id == w["worker_id"] for r in serve.monitor.completed)
        print(f"  pair {w['worker_id']}: healthy={w['healthy']} "
              f"acceptance={w['acceptance']:.2f} cache_hit={w['cache_hit_rate']:.2f} "
              f"served={served}")
    if args.trace_out:
        serve.export_chrome_trace(args.trace_out)
        print(f"wrote Chrome trace to {args.trace_out} (chrome://tracing or ui.perfetto.dev)")
    return {"summary": s, "serve": serve, "config": cfg}


if __name__ == "__main__":
    main()
