"""Topology-free checkpoints (a port of ``repro.training.checkpoint``, the
same files on disk).

One ``.npy`` per leaf plus a JSON manifest under ``step_<n>/``, with an
atomic ``LATEST`` pointer.  Write protocol: write into ``step_<n>.tmp/``,
fsync the manifest, rename to ``step_<n>/``, then rewrite ``LATEST`` by
rename; ``keep`` checkpoints are retained.  bfloat16 leaves are stored as
their uint16 bits (numpy has no bfloat16 without ``ml_dtypes``), with the
logical dtype in the manifest; a reference checkpoint's bfloat16 leaves,
stored widened to float32, read back exactly too.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil

import numpy as np
import torch

from repro_torch.params import tree_items, tree_map


def _decode(arr, dtype):
    """A loaded leaf as a CPU tensor of its logical ``dtype``."""
    if dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr).to(getattr(torch, dtype))


class CheckpointManager:
    def __init__(self, directory, keep=3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step, state):
        """``state``: trees of tensors by group ("params", "opt", ...) and a
        JSON-able "meta"."""
        tmp, final = self.dir / f"step_{step:08d}.tmp", self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}}
        for group, tree in state.items():
            if group == "meta":
                manifest["meta"] = tree
                continue
            for key, leaf in tree_items(tree):
                t = leaf.detach().cpu()
                dtype = str(t.dtype).removeprefix("torch.")
                arr = t.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" \
                    else t.numpy()
                fname = f"{group}__{key.replace('/', '__')}.npy"
                np.save(tmp / fname, arr)
                manifest["leaves"][f"{group}/{key}"] = {"file": fname, "shape": list(arr.shape),
                                                         "dtype": dtype}
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        (self.dir / "LATEST.tmp").write_text(str(step))
        (self.dir / "LATEST.tmp").rename(self.dir / "LATEST")
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
        return final

    def steps(self):
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self):
        ptr = self.dir / "LATEST"
        if ptr.exists():
            s = int(ptr.read_text().strip())
            if (self.dir / f"step_{s:08d}").exists():
                return s
        steps = self.steps()
        return steps[-1] if steps else None

    def read(self, step=None):
        """(step, {"group/key": CPU tensor of its logical dtype}, meta)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        leaves = {key: _decode(np.load(path / e["file"]), e["dtype"])
                  for key, e in manifest["leaves"].items()}
        return step, leaves, manifest.get("meta", {})

    def restore(self, templates, step=None):
        """Restore into the structure of ``templates`` (the trees passed to
        ``save``; each leaf gives only its place and device)."""
        step, leaves, meta = self.read(step)
        out = {}
        for group, tree in templates.items():
            if group == "meta":
                out["meta"] = meta
                continue
            keys = iter(f"{group}/{k}" for k, _ in tree_items(tree))
            out[group] = tree_map(lambda t: leaves[next(keys)].to(t.device), tree)
        return step, out
