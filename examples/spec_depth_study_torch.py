"""Speculation-depth study on the PyTorch port's simulator: sweep fixed
depths against SpecuStream on each workload, the paper's Table 9 mechanism,
suite by suite.  Its rates are model predictions from the H100 SXM
data-sheet profile (the discrete-event simulator runs on the host), not
measurements.

  PYTHONPATH=src python examples/spec_depth_study_torch.py
"""
from repro_torch.api import ServeConfig
from repro_torch.data.workloads import sample_requests
from repro_torch.serving.simulator import ServeSimulator

DEPTHS = (0, 2, 3, 5, 8, 12, 20)


def main():
    base = ServeConfig.paper_stream_pairs("llama2-7b", max_batch=32, kv_blocks=2048)
    cfg = base.build_arch_config()
    print("mean tokens/s a request (model prediction, H100 SXM data-sheet profile)")
    print(f"{'workload':10s} " + " ".join(f"d={d:<4d}" for d in DEPTHS) + " adaptive")
    table = {}
    for wl in ("alpaca", "gsm8k", "humaneval", "sum"):
        row = []
        for conf in [base.replace(spec_policy="fixed" if d > 0 else "none",
                                  fixed_depth=d).to_sim_config() for d in DEPTHS] + [
                base.to_sim_config()]:
            s = ServeSimulator(cfg, conf).run(sample_requests(wl, 80, seed=0, arrival_rate=10.0))
            row.append(s["throughput_mean"])
        *fixed, ada = row
        ratio = ada / max(fixed[1:])
        table[wl] = {"fixed": dict(zip(DEPTHS, fixed, strict=True)), "adaptive": ada,
                     "adaptive_over_best_fixed": ratio}
        print(f"{wl:10s} " + " ".join(f"{x:6.0f}" for x in fixed)
              + f" {ada:8.0f}   (adaptive / best fixed: {ratio:.2f}x)")
    below = [wl for wl, r in table.items() if r["adaptive_over_best_fixed"] < 1.0]
    print("\nhigher-acceptance suites (sum) reward deeper speculation; volatile suites "
          "(gsm8k) punish it.  Adaptive is below the best fixed depth in "
          f"{len(below)} of {len(table)} suites" + (f" ({', '.join(below)})" if below else ""))
    return table


if __name__ == "__main__":
    main()
