"""The dry run's command line: every (assigned arch x shape x mesh) cell
counted on one rank without a device (``launch.dryrun_lib``).

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--force]
    python -m repro_torch.launch.dryrun --list

Cells run in this process, one after another (a fake process group has no
device count to lock), and each result is kept as
``experiments/dryrun_torch/<mesh>_<arch>_<shape>[_spec<k>].json``: ``--all``
reuses a kept cell unless ``--force``.  Each line gives the per-device
counts, the peak and the three roofline terms in seconds on the H100
data-sheet constants of ``launch.mesh`` (predictions, not measurements).
Designed skips print as such, apart from failures; the exit code is
nonzero only on a failure.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import traceback

from repro_torch.configs import ASSIGNED, SHAPES, get_config, shape_applicable

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def run_one(arch, shape, mesh, spec_tokens=0, force=True):
    """Count one cell (or read it back) and print its line; False if it
    failed."""
    from repro_torch.launch.dryrun_lib import CellResult, lower_cell, roofline_terms
    from repro_torch.launch.mesh import PRODUCTION_MESHES

    path = RESULTS_DIR / f"{mesh}_{arch}_{shape}{f'_spec{spec_tokens}' * bool(spec_tokens)}.json"
    tag = "cached"
    if force or not path.exists():
        try:
            res = lower_cell(arch, shape, mesh, spec_tokens)
        except Exception as e:  # a failure is this cell's result; the others go on
            traceback.print_exc()
            res = CellResult(arch, shape, mesh, "error", 0.0, error=repr(e))
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(res.to_json(), indent=2))
        tag = res.status
    else:
        res = CellResult(**json.loads(path.read_text()))
    terms = roofline_terms(res, PRODUCTION_MESHES[mesh])
    top = max(terms, key=terms.get) if res.status == "ok" else "-"
    print(f"[{tag:10s}] {mesh:6s} {arch:24s} {shape:12s} {res.seconds:6.1f}s "
          f"flops/dev={res.flops_per_device:.3e} bytes/dev={res.bytes_per_device:.3e} "
          f"coll={res.collectives.get('total', 0):.3e}B "
          f"peak={res.peak_memory_per_device / 1e9:.2f}GB "
          + " ".join(f"{k}={v:.3e}" for k, v in terms.items())
          + f" dominant={top} {res.error[:70]}", flush=True)
    return res.status != "error"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--spec-tokens", type=int, default=0)
    for flag in ("--all", "--force", "--list"):
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args(argv)
    if args.list:
        for arch in ASSIGNED:
            for shape in SHAPES.values():
                ok, why = shape_applicable(get_config(arch), shape)
                print(f"{arch:24s} {shape.name:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return 0
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    cells = [(a, s) for a in ASSIGNED for s in SHAPES] if args.all else [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    ok = [run_one(a, s, m, args.spec_tokens, args.force or not args.all)
          for m in meshes for a, s in cells]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
