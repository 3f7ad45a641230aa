"""The training entry point: checkpoint/restart, int8 gradient compression
and an injected mid-run failure (a port of ``repro.launch.train``).

  python -m repro_torch.launch.train --device cpu --steps 20 --fail-at 8
  python -m repro_torch.launch.train --device cpu --steps 20 --compress-grads
  python -m repro_torch.launch.train --no-reduced      # full width, on the card

``--fail-at N`` raises at step N; the ``TrainSupervisor`` restores the latest
checkpoint and replays, and the run ends with the final loss of an
uninterrupted run, bit for bit; with ``--compress-grads`` the
error-feedback tree is saved and restored with the optimizer state, so a
compressed run replays exactly too.  On a CUDA device the trainer turns on
PyTorch's deterministic algorithms (and cuBLAS's fixed workspace) so that a
replay is exact there too; attention runs K2's forward and backward kernels.
A vision-prefix model trains behind zero patches and an encoder-decoder on 16
zero frames a row, as the reference's CLI feeds them (its stub: at the
models' depth of 24 these zeros overflow the gradient, the reference's too).
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True,
                    help="reduced CPU-sized model (--no-reduced: full width)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradients with error feedback")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="torch device (cpu for a CPU run)")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch.train: CUDA is not available (--device cpu runs the "
                               "plain PyTorch versions of the kernels on the CPU)")
        # exact replays: deterministic index accumulation, fixed cuBLAS workspaces
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.workloads import TokenStream
    from repro_torch.distributed.compression import GradientCompressor
    from repro_torch.distributed.fault_tolerance import TrainSupervisor
    from repro_torch.models import build_model
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import make_train_step

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device)
    init_opt, train_step = make_train_step(
        model, OptConfig(learning_rate=args.lr, warmup_steps=5, total_steps=args.steps),
        compression=GradientCompressor() if args.compress_grads else None)
    params = model.init(0)
    stream = TokenStream(cfg.vocab_size, args.seq_len, args.batch, seed=1)
    ckpt = CheckpointManager(args.ckpt_dir)
    state = {"params": params, "opt": init_opt(params)}
    losses = {}

    def make_batch(step):
        """The step's tokens, and the reference's stub inputs: zero patches
        (a vision frontend) or 16 zero frames (an encoder-decoder)."""
        stream.step = step  # deterministic per-step data (replay-safe)
        batch = {"tokens": torch.from_numpy(next(stream)).to(device)}
        zeros = functools.partial(torch.zeros, dtype=getattr(torch, cfg.dtype), device=device)
        if cfg.frontend is not None and cfg.frontend.kind == "vision":
            batch["patches"] = zeros(args.batch, cfg.frontend.n_tokens, cfg.d_model)
        if cfg.is_encdec:
            batch["frames"] = zeros(args.batch, 16, cfg.d_model)
        return batch

    def run_step(step):
        if step == args.fail_at:
            args.fail_at = -1  # once
            raise RuntimeError(f"injected failure at step {step}")
        state["params"], state["opt"], metrics = train_step(state["params"], state["opt"],
                                                            make_batch(step))
        losses[step] = float(metrics["loss"])
        if step % args.log_every == 0:
            print(f"step {step:5d}  loss {losses[step]:.4f}  lr {float(metrics['lr']):.2e}")

    def save(step):
        ckpt.save(step, {"params": state["params"], "opt": state["opt"],
                         "meta": {"stream": stream.state_dict(), "arch": cfg.name}})

    def restore():
        if ckpt.latest_step() is None:
            save(0)
            return 0
        step, restored = ckpt.restore({"params": state["params"], "opt": state["opt"],
                                       "meta": {}})
        state["params"], state["opt"] = restored["params"], restored["opt"]
        if "stream" in restored["meta"]:
            stream.load_state_dict(restored["meta"]["stream"])
        print(f"restored checkpoint at step {step}")
        return step

    sup = TrainSupervisor(run_step, save, restore, checkpoint_every=args.ckpt_every)
    t0 = time.perf_counter()
    report = sup.run(args.steps)
    dt = time.perf_counter() - t0
    first = losses[min(losses)] if losses else float("nan")
    last = losses[max(losses)] if losses else float("nan")
    print(f"done: {report.steps_run} steps in {dt:.1f}s, {report.restarts} restarts; "
          f"loss {first:.4f} -> {last:.4f}")
    return {"losses": losses, "report": report, "final_loss": last}


if __name__ == "__main__":
    main()
