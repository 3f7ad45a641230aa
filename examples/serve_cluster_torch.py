"""End-to-end driver on the PyTorch port: serve a small model with batched
requests through the whole StreamServe stack, exercising in one run

  * disaggregated stream pairs (prefill lane + decode lane)
  * FlowGuard multi-signal routing with overload exclusion
  * SpecuStream runtime-adaptive speculation (watch depths move)
  * continuous batching with prefix-cache reuse
  * a mid-run worker FAILURE with automatic re-routing
  * ELASTIC scale-out under load (the discrete-event simulator: its
    latencies and rates are model predictions from the H100 SXM data-sheet
    profile, not measurements)

The engine runs on an NVIDIA GPU by default (``--device cpu``: on the CPU);
the simulator runs on the host either way.

  PYTHONPATH=src python examples/serve_cluster_torch.py
  PYTHONPATH=src python examples/serve_cluster_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.api import ServeConfig, StreamServe
from repro_torch.data.workloads import sample_mixed, sample_requests
from repro_torch.serving.simulator import ServeSimulator

PREDICTION = "model prediction, H100 SXM data-sheet profile"


def real_engine_demo(device="cuda"):
    print("=" * 70)
    print(f"THE PORT'S ENGINE (reduced model, {device}): failure + re-route")
    print("=" * 70)
    serve = StreamServe(ServeConfig.reduced_smoke("qwen3-1.7b"), device=device)
    rng = np.random.default_rng(1)
    handles = [serve.submit(rng.integers(0, serve.arch.vocab_size, 12).tolist())
               for _ in range(8)]
    for _ in range(4):
        serve.step()
    before = {h.request_id for h in handles if h.done}
    n = serve.fail_worker(1)
    print(f"  !! pair 1 died; {n} requests re-routed to pair 0")
    serve.run_until_done(max_steps=800)
    done = serve.monitor.completed
    print(f"  completed {len(done)}/8 on pairs {sorted(set(r.worker_id for r in done))}\n")
    assert len(done) == 8
    assert all(h.done for h in handles)
    # every request still open when pair 1 died finished on pair 0
    assert all(r.worker_id == 0 for r in done if r.request_id not in before)
    return {"completed": len(done), "rerouted": n, "done_before_failure": len(before),
            "pairs": sorted(set(r.worker_id for r in done))}


def cluster_scale_demo():
    print("=" * 70)
    print(f"CLUSTER SCALE (event simulator, llama2-7b costs; {PREDICTION}): elastic scale-out")
    print("=" * 70)
    scfg = ServeConfig.paper_stream_pairs("llama2-7b", max_batch=32, kv_blocks=2048)
    cfg = scfg.build_arch_config()
    # phase 1: two pairs under rising mixed multi-tenant load
    sim = ServeSimulator(cfg, scfg.to_sim_config())
    reqs = sample_mixed(60, seed=0, arrival_rate=40.0)  # 240 requests at 40/s
    # a worker fails at t=1s; a replacement pair joins at t=0 (warm spare)
    sim.inject_failure(1.0, wid=0)
    sim.add_worker()
    s = sim.run(reqs)
    print("  240 mixed requests @40/s, pair-0 dies at t=1.0s, spare pair active:")
    print(f"    completed {int(s['n'])}  latency p50 {s['latency_p50'] * 1e3:.0f} ms  "
          f"p99 {s['latency_p99'] * 1e3:.0f} ms  agg {s['aggregate_tput']:.0f} tok/s")
    by_w = {}
    for r in sim.monitor.completed:
        by_w[r.worker_id] = by_w.get(r.worker_id, 0) + 1
    print(f"    requests per pair: {dict(sorted(by_w.items()))}")
    assert int(s["n"]) == 240
    # phase 2: depth adaptation visibility
    print("\n  SpecuStream depth trace (pair 1, first 12 decode ticks):")
    for t in [x for x in sim.trace if x["wid"] == 1][:12]:
        print(f"    t={t['t'] * 1e3:7.1f} ms  depth={t['depth']:2d}  "
              f"batch={t['batch']:2d}  emitted={t['emitted']:3d}  acc={t['acc']:.2f}")
    return s


def workload_comparison():
    print("=" * 70)
    print(f"WORKLOAD SENSITIVITY (the paper's §4.2-4.5 narrative; {PREDICTION})")
    print("=" * 70)
    scfg = ServeConfig.paper_stream_pairs("llama2-7b", max_batch=32, kv_blocks=2048)
    cfg = scfg.build_arch_config()
    out = {}
    for wl in ("alpaca", "gsm8k", "humaneval", "sum"):
        sim = ServeSimulator(cfg, scfg.to_sim_config())
        s = out[wl] = sim.run(sample_requests(wl, 80, seed=0, arrival_rate=10.0))
        depths = [t["depth"] for t in sim.trace if t["depth"] > 0]
        print(f"  {wl:10s}  latency {s['latency_mean'] * 1e3:6.0f} ms   "
              f"tput {s['throughput_mean']:7.1f} tok/s   mean spec depth {np.mean(depths):.1f}")
    return out


def main(device="cuda"):
    out = {"engine": real_engine_demo(device), "cluster": cluster_scale_demo(),
           "workloads": workload_comparison()}
    print("\nOK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
