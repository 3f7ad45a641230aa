"""Fault-tolerant training on the PyTorch port: checkpoint/restart with a
mid-run crash, int8 gradient compression with error feedback, and recovery
bit for bit, with and without compression.  On an NVIDIA GPU by default;
``--device cpu`` runs the plain versions of the kernels on the CPU.

  PYTHONPATH=src python examples/train_resilient_torch.py
  PYTHONPATH=src python examples/train_resilient_torch.py --device cpu --steps 12
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train_main


def main(steps=30, device="cuda", arch="mamba2-2.7b"):
    base = tempfile.mkdtemp(prefix="repro_torch_train_")
    every, fail_at = max(steps // 3, 1), steps * 17 // 30
    runs = {}
    try:
        for name, title, extra in (
                ("A", f"uninterrupted {steps} steps", []),
                ("B", f"crash injected at step {fail_at}, restored from the last checkpoint",
                 ["--fail-at", str(fail_at)]),
                ("C", "int8 gradient compression with error feedback", ["--compress-grads"]),
                ("D", f"compressed, crash injected at step {fail_at}",
                 ["--compress-grads", "--fail-at", str(fail_at)])):
            print(("\n" if runs else "") + "=" * 70 + f"\nrun {name}: {title}\n" + "=" * 70)
            runs[name] = train_main(["--arch", arch, "--steps", str(steps), "--device", device,
                                     "--ckpt-dir", f"{base}/{name}", "--ckpt-every", str(every),
                                     *extra])
        a, b, c, d = (runs[k]["final_loss"] for k in "ABCD")
        print(f"\nfinal losses: A={a:.4f}  B={b:.4f}  C={c:.4f}  D={d:.4f}")
        assert abs(a - b) < 1e-4, "crash-restart must replay to the identical state"
        assert abs(a - c) < 0.1, "int8-compressed training must track the uncompressed run"
        assert runs["D"]["losses"] == runs["C"]["losses"], (
            "a compressed restart must replay its error feedback exactly")
        print("OK: restart is bit-deterministic, with and without compression; "
              "compression tracks the uncompressed run")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return runs


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.steps, args.device)
