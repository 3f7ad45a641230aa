"""Topology-free checkpoints (a port of ``repro.training.checkpoint``, the
same files on disk).

One ``.npy`` per leaf plus a JSON manifest under ``step_<n>/``, with an
atomic ``LATEST`` pointer.  Write protocol: write into ``step_<n>.tmp/``,
fsync the manifest, rename to ``step_<n>/``, then rewrite ``LATEST`` by
rename; ``keep`` checkpoints are retained.  bfloat16 leaves are stored as
their uint16 bits (numpy has no bfloat16 without ``ml_dtypes``), with the
logical dtype in the manifest; a reference checkpoint's bfloat16 leaves,
stored widened to float32, read back exactly too.

Under a mesh (``places``: where each rank's leaf starts in the whole leaf,
from ``train_step.places``) a checkpoint is the same files: ``save`` is
collective and writes each leaf whole, its distinct pieces broadcast to rank
0, the one writer, one leaf at a time, while the other ranks wait; and
``restore`` narrows each whole leaf to the piece the rank holds under the
mesh it restores onto.  So a checkpoint written at one mesh shape or world
size, or without a mesh, restores at any other (the reference's elastic
restart: sharding is applied at load, not baked into the files).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.params import tree_items, tree_map


def _decode(arr, dtype):
    """A loaded leaf as a CPU tensor of its logical ``dtype``."""
    if dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr).to(getattr(torch, dtype))


def _whole(x, starts):
    """The whole leaf of which ``x`` is this rank's piece, starting at
    ``starts``, on rank 0 (None on the others; every rank calls this): the
    ranks' places all-gathered, then each distinct piece broadcast from the
    first rank that holds it.  A leaf every rank holds whole goes nowhere."""
    if not x.dim():
        return x.detach().cpu()
    me, x = dist.get_rank(), x.detach().contiguous()
    box = torch.tensor([*starts, *x.shape], device=x.device)
    boxes = box.new_empty(dist.get_world_size() * len(box))
    dist.all_gather_into_tensor(boxes, box)
    pieces = {}  # (starts, shape) -> the first rank that holds it
    for r, b in enumerate(boxes.view(-1, 2, x.dim()).tolist()):
        pieces.setdefault(tuple(map(tuple, b)), r)
    if len(pieces) == 1:
        return x.cpu() if me == 0 else None
    shape = torch.tensor([[a + n for a, n in zip(*p)] for p in pieces]).amax(0).tolist()
    out = torch.empty(shape, dtype=x.dtype) if me == 0 else None
    for (st, sh), r in pieces.items():
        buf = x if r == me else x.new_empty(sh)
        dist.broadcast(buf, src=r)
        if me == 0:
            out[tuple(slice(a, a + n) for a, n in zip(st, sh))] = buf.cpu()
    return out


class CheckpointManager:
    def __init__(self, directory, keep=3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step, state, places=None):
        """``state``: trees of tensors by group ("params", "opt", ...) and a
        JSON-able "meta".  Under a mesh, ``places`` ({group: each leaf's
        start in the whole leaf, in ``tree_items`` order}) and every rank
        calls this; rank 0 writes and the others wait for it."""
        writer = places is None or dist.get_rank() == 0
        tmp, final = self.dir / f"step_{step:08d}.tmp", self.dir / f"step_{step:08d}"
        if writer:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}}
        for group, tree in state.items():
            if group == "meta":
                manifest["meta"] = tree
                continue
            for (key, leaf), starts in zip(tree_items(tree), places[group] if places else
                                           [None] * len(tree_items(tree)), strict=True):
                t = leaf.detach().cpu() if places is None else _whole(leaf, starts)
                if not writer:
                    continue
                dtype = str(t.dtype).removeprefix("torch.")
                arr = t.view(torch.int16).numpy().view(np.uint16) if dtype == "bfloat16" \
                    else t.numpy()
                fname = f"{group}__{key.replace('/', '__')}.npy"
                np.save(tmp / fname, arr)
                manifest["leaves"][f"{group}/{key}"] = {"file": fname, "shape": list(arr.shape),
                                                         "dtype": dtype}
                del t, arr  # one whole leaf at a time
        if writer:
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
        if places is not None:
            dist.barrier()
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

    def _path(self, step):
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        return step, path, json.loads((path / "manifest.json").read_text())

    def read(self, step=None):
        """(step, {"group/key": CPU tensor of its logical dtype}, meta)."""
        step, path, manifest = self._path(step)
        leaves = {key: _decode(np.load(path / e["file"]), e["dtype"])
                  for key, e in manifest["leaves"].items()}
        return step, leaves, manifest.get("meta", {})

    def restore(self, templates, step=None, places=None):
        """Restore into the structure of ``templates`` (the trees passed to
        ``save``; each leaf gives its place, device and, under a mesh, the
        shape of the rank's piece, which starts in the whole leaf where
        ``places`` says: the piece is read from the whole leaf's file, one
        leaf at a time)."""
        step, path, manifest = self._path(step)
        out = {}
        for group, tree in templates.items():
            if group == "meta":
                out["meta"] = manifest.get("meta", {})
                continue
            leaves = iter(zip(tree_items(tree), places[group] if places else
                              [None] * len(tree_items(tree)), strict=True))

            def load(t, group=group):
                (key, _), starts = next(leaves)
                e = manifest["leaves"][f"{group}/{key}"]
                arr = np.load(path / e["file"], mmap_mode="r")
                if starts is not None:
                    arr = arr[tuple(slice(a, a + n) for a, n in zip(starts, t.shape, strict=True))]
                return _decode(np.array(arr), e["dtype"]).to(t.device)

            out[group] = tree_map(load, tree)
        return step, out
