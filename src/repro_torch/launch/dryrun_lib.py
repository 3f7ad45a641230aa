"""The dry run: one rank's serving step of every (arch x shape x mesh) cell,
counted without a device (a port of ``repro.launch.dryrun_lib``).

The reference lowers and compiles each cell under GSPMD for 256 or 512
faked host devices.  The port runs one rank's program (rank 0: the rank
that holds the most query heads) on meta tensors of its shard shapes,
under a fake process group of the mesh's size: every op and collective
reaches :class:`~repro_torch.launch.op_analysis.OpAnalyzer`, nothing is
computed and nothing is allocated.  The same step runs on CUDA tensors
under the same analyzer (``device="cuda"``, a one-device size mapping) to
hold the two counts alike.  Serving steps run under ``INFERENCE_RULES``;
a training step (``train_4k``) under the reference's choice: ZeRO-1
(``ZERO1_PARAM_RULES``) where the bf16 weights a model rank holds fit
``ZERO1_WEIGHT_BYTES_LIMIT``, else FSDP (``DEFAULT_RULES``), the optimizer
state under ``DEFAULT_RULES`` either way; the analyzer counts its forward,
backward (remat's recomputation included) and update.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (DEFAULT_RULES, INFERENCE_RULES, batch_axes,
                                              local_shape, logical_to_spec, make_mesh, mesh_sizes,
                                              param_axes, shard_params, use_mesh, use_rules)
from repro_torch.launch.mesh import (HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     PRODUCTION_MESHES, in_one_node, mesh_chips)
from repro_torch.launch.op_analysis import COLLECTIVES, OpAnalyzer
from repro_torch.models.model import Model
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import make_train_step


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str  # ok | skipped | error
    seconds: float
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    matmul_flops_per_device: float = 0.0  # the matmul family's and the kernels' products
    peak_memory_per_device: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    collectives: dict = dataclasses.field(default_factory=dict)
    collectives_by_axis: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    error: str = ""

    def to_json(self):
        return dataclasses.asdict(self)


@contextlib.contextmanager
def fake_world(sizes):
    """A DeviceMesh of ``sizes`` ({axis: size}) over a fake process group:
    rank 0 of their product, no device, no peer."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh_chips(sizes))
    try:
        yield make_mesh(tuple(sizes.values()), tuple(sizes), "cpu")
    finally:
        dist.destroy_process_group()


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _batch(cfg, shape, mesh, device, gen):
    """The rank's rows of the step's batch (the reference's ``batch_specs``):
    tokens, behind a vision frontend's patches or an encoder's frames (and
    then, training, max(S // 4, 16) target tokens)."""
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    front = cfg.frontend.n_tokens if cfg.frontend is not None else 0
    shapes = ({"frames": (B, S, d), "tokens": (B, max(S // 4, 16) if shape.kind == "train" else 1)}
              if cfg.is_encdec else
              {"patches": (B, front, d), "tokens": (B, S - front)} if front else
              {"tokens": (B, S)})
    out, axes = {}, batch_axes(shapes)
    for k, v in shapes.items():
        v = local_shape(v, logical_to_spec(axes[k], mesh, INFERENCE_RULES, v), mesh_sizes(mesh))
        out[k] = (torch.randint(0, cfg.vocab_size, v, generator=gen, device=device,
                                dtype=torch.int32) if k == "tokens"
                  else torch.randn(v, generator=gen, device=device).to(getattr(torch, cfg.dtype)))
    return out


def lower_cell(arch, shape_name, mesh_kind="single", spec_tokens=0, *, cfg=None, shape=None,
               sizes=None, device="meta", after=None):
    """Count one cell's step on rank 0.  ``spec_tokens > 0`` counts the
    verify step (T = spec_tokens + 1) in place of plain decode.  ``cfg`` (an
    ArchConfig), ``shape`` (a ShapeConfig) and ``sizes`` ({axis: size})
    replace the arch's config, the reference's shape and its production
    mesh; on one device (every size 1) ``device="cuda"`` runs the step on
    the card with seeded weights, and ``after(step)`` may run it again."""
    t0 = time.perf_counter()
    cfg, shape = cfg or get_config(arch), shape or SHAPES[shape_name]
    sizes = sizes or PRODUCTION_MESHES[mesh_kind]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return CellResult(arch, shape_name, mesh_kind, "skipped", 0.0, error=why)
    train = shape.kind == "train"  # the reference's choice, its constant read at call time:
    fsdp = train and 2.0 * cfg.n_params() / sizes.get("model", 1) > sharding.ZERO1_WEIGHT_BYTES_LIMIT
    rules = DEFAULT_RULES if fsdp else INFERENCE_RULES  # ZERO1_PARAM_RULES are INFERENCE_RULES
    with contextlib.ExitStack() as stack:
        mesh = stack.enter_context(fake_world(sizes)) if mesh_chips(sizes) > 1 else sizes
        stack.enter_context(use_rules(rules))
        stack.enter_context(use_mesh(mesh))
        if not train:
            stack.enter_context(torch.no_grad())  # inference mode would hide the aten ops
        model = Model(cfg, device)
        full = model.init(0)
        params = shard_params(full, param_axes(full), mesh, rules, cfg)
        del full
        gen = None if device == "meta" else torch.Generator(device=device).manual_seed(0)
        batch = _batch(cfg, shape, mesh, device, gen)
        args = [params, batch]
        if train:
            init_opt, train_step = make_train_step(model, OptConfig())
            args.insert(1, init_opt(params))

            def step():
                return train_step(*args)
        elif shape.kind == "prefill":
            def step():
                return model.prefill(params, batch, max_len=shape.seq_len)
        else:
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     cross_len=cfg.frontend.n_tokens if cfg.is_encdec else None)
            tokens = batch["tokens"][:, :1].expand(-1, spec_tokens + 1).contiguous()
            args = [params, cache, tokens]

            def step():
                return model.decode_step(params, cache, tokens)
        arg_bytes = _nbytes(args)  # before the step: decode adds the SSM's per-step states
        with OpAnalyzer(mesh) as analyzer:
            out = step()
        c = analyzer.cost
        out_bytes = _nbytes(out)
        res = CellResult(
            arch, shape_name, mesh_kind, "ok", round(time.perf_counter() - t0, 1),
            flops_per_device=c.flops, bytes_per_device=c.bytes,
            matmul_flops_per_device=sum(v for k, v in c.flops_by_op.items()
                                        if k == "matmul" or k in c.kernels),
            peak_memory_per_device=analyzer.peak_bytes,
            argument_bytes=arg_bytes, output_bytes=out_bytes,
            # a training step's outputs are its arguments, updated in place
            temp_bytes=analyzer.peak_bytes - out_bytes * (not train),
            collectives={**{k: c.collectives.get(k, 0.0) for k in COLLECTIVES},
                         "total": sum(c.collectives.values())},
            collectives_by_axis=c.collectives_by_axis, kernels=c.kernels)
        del out
        if after is not None:  # the caller measures the same step, unanalyzed
            after(step)
    return res


def roofline_terms(res, mesh):
    """Three-term roofline (seconds) of a cell's per-device counts on the
    H100 data-sheet constants of ``launch.mesh`` (predictions, not
    measurements): FLOPs over the bf16 peak, bytes over HBM, and each mesh
    axis's collective bytes over NVLink where its group lies inside one
    8-GPU node, else over the network.  ``mesh`` is a DeviceMesh or a
    mapping of sizes."""
    coll = sum(sum(kinds.values()) / (NVLINK_BW if in_one_node(mesh, axis) else NET_BW)
               for axis, kinds in res.collectives_by_axis.items())
    return {"compute_s": res.flops_per_device / PEAK_FLOPS_BF16,
            "memory_s": res.bytes_per_device / HBM_BW, "collective_s": coll}
