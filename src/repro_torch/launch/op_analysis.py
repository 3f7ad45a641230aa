"""Per-device cost of one rank's program, op by op (the port's counterpart of
``repro.launch.hlo_analysis``).

The reference walks the post-SPMD HLO of a compiled step.  The port has no
compiled program: it runs the rank's step eagerly (on meta tensors for the
dry run, on the card to hold the two alike) under :class:`OpAnalyzer`, a
``TorchDispatchMode`` that sees every aten op and every c10d collective
once per call, so loops count as often as they run.  It accumulates:

* ``flops``: 2·|out|·K for the matmul family, |out| for pointwise ops, and
  each kernel's own count (``kernels.cost``);
* ``bytes``: inputs plus outputs of every op.  This is eager traffic: the
  port fuses nothing, where the reference bills a fusion at its boundary.
  Views move 0 bytes; a gather bills twice its output plus its index; an op
  that writes into part of a tensor bills what it reads besides and the
  largest of that again (the region written), not the whole tensor;
* ``collectives``: each c10d op's result bytes under the reference's five
  kinds, and in ``collectives_by_axis`` under the mesh axis of its group;
* ``transcendentals``, ``bytes_by_op``, ``flops_by_op`` and ``kernels``
  (calls by name);
* live bytes: storages the step allocates, released when their last tensor
  is collected; ``peak_bytes`` is their peak.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cost as kernel_cost

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
_C10D = {"allreduce_": 0, "_allgather_base_": 1, "_reduce_scatter_base_": 2, "send": 4,
         "recv_": 4}  # the port's collectives: their kind in COLLECTIVES
_aten = torch.ops.aten
MATMUL = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten.addmm.default: 1,
          _aten.baddbmm.default: 1}  # op: the argument index of the left operand
GATHERS = {_aten.index.Tensor, _aten.gather.default, _aten.index_select.default}
TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt", "silu", "gelu", "softplus",
                  "sin", "cos", "pow", "erf"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    transcendentals: float = 0.0
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    collectives_by_axis: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)

    def add(self, op, flops=0.0, nbytes=0.0):
        self.flops += flops
        self.bytes += nbytes
        for d, v in ((self.flops_by_op, flops), (self.bytes_by_op, nbytes)):
            d[op] = d.get(op, 0.0) + v


def _tensors(x):
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def _size(ts):
    return sum(t.numel() * t.element_size() for t in ts)


class OpAnalyzer(TorchDispatchMode):
    """``with OpAnalyzer(mesh) as a:`` counts what runs inside into
    ``a.cost``; ``mesh`` (a DeviceMesh) names each collective's axis."""

    def __init__(self, mesh=None):
        super().__init__()
        self.cost, self.paused, self.live, self.peak_bytes = Cost(), 0, 0, 0
        self.axes = {mesh.get_group(a).group_name: a for a in getattr(mesh, "mesh_dim_names", ())}
        self._held = {}  # storage key -> [bytes, tensors alive]

    def __enter__(self):
        kernel_cost.ANALYZERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_cost.ANALYZERS.remove(self)
        return super().__exit__(*exc)

    def add_kernel(self, name, flops, nbytes):
        self.cost.add(name, flops, nbytes)
        self.cost.kernels[name] = self.cost.kernels.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors([*args, *(kwargs or {}).values()]), _tensors(out)
        if not self.paused:
            self._count(func, args, ins, outs)
        self._track(ins, outs)
        return out

    def _count(self, func, args, ins, outs):
        name, c = func.__name__.split(".")[0], self.cost
        if func.namespace == "c10d":
            if name in _C10D:
                kind = COLLECTIVES[_C10D[name]]
                nb = _size(outs[:1] if name.startswith("_") else _tensors(args[0]))
                group = next(a for a in args if isinstance(a, torch.ScriptObject))
                axis = self.axes.get(dist.ProcessGroup.unbox(group).group_name, "?")
                for d in (c.collectives, c.collectives_by_axis.setdefault(axis, {})):
                    d[kind] = d.get(kind, 0.0) + nb
                c.add(kind, 0.0, nb)
            return
        alias = func._schema.returns[0].alias_info if func._schema.returns else None
        if alias is not None and not alias.is_write or name.startswith("empty"):
            return  # a view, or an allocation that writes nothing
        if func in MATMUL:
            c.add("matmul", 2 * outs[0].numel() * args[MATMUL[func]].shape[-1],
                  _size(ins) + _size(outs))
        elif torch.Tag.pointwise in func.tags:
            n = outs[0].numel() if outs else 0
            c.add("pointwise", n, _size(ins) + _size(outs))
            c.transcendentals += n * (name.rstrip("_") in TRANSCENDENTAL)
        elif func in GATHERS:
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            c.add(name, 0.0, 2 * _size(outs) + _size(idx))
        elif alias is not None:  # writes into part of its first argument
            c.add(name, 0.0, _size(ins[1:]) + max(map(_size, ([t] for t in ins[1:])), default=0))
        else:
            c.add(name, 0.0, _size(ins) + _size(outs))

    def _track(self, ins, outs):
        """Count each storage the step allocates while a tensor holds it."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            key = t.untyped_storage()._cdata
            if key in seen:
                continue
            if key not in self._held:
                self._held[key] = [t.untyped_storage().nbytes(), 0]
                self.live += self._held[key][0]
                self.peak_bytes = max(self.peak_bytes, self.live)
            self._held[key][1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key):
        held = self._held[key]
        held[1] -= 1
        if not held[1]:
            self.live -= held[0]
            del self._held[key]
