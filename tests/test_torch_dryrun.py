"""M12, the dry run, on the CPU: the op analyzer on programs of known cost
(``tests/test_hlo_analysis.py``'s cases), the shapes and cells against the
reference's, every serving and training cell at full width on meta with
each rank's argument bytes against what the reference's specs give, and
reduced models on debug meshes against the reference's compiled HLO (one
JAX subprocess with eight host devices, the reference's ``lower_cell``
given the reduced configs, small shapes and (2, 2) / (2, 2, 2) meshes, FSDP
forced by ``ZERO1_WEIGHT_BYTES_LIMIT`` in that subprocess; no reference
file edited).

    PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun.py
"""
import concurrent.futures
import dataclasses
import functools
import json
import math
import multiprocessing
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch
import torch.distributed as dist
from test_torch_engine import _one_torch_thread  # noqa: F401

from repro import configs as jax_configs
from repro.distributed import sharding as jax_sharding
from repro.launch import dryrun_lib as jax_dryrun
from repro.models import build_model as jax_build
from repro.training.train_loop import make_train_step, opt_state_axes
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun_lib
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.launch.op_analysis import OpAnalyzer
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"p": configs.ShapeConfig("p", "prefill", 64, 4),
         "d": configs.ShapeConfig("d", "decode", 64, 8),
         "t": configs.ShapeConfig("t", "train", 64, 8),
         "tf": configs.ShapeConfig("tf", "train", 64, 8)}  # "tf": FSDP forced
LOWERED = [(m, a, s) for m in ("single", "multi")
           for a in ("qwen3-1.7b", "mixtral-8x7b", "mamba2-2.7b") for s in ("p", "d")]
LOWERED += [("single", a, "t") for a in ("qwen3-1.7b", "mixtral-8x7b", "mamba2-2.7b")]
LOWERED += [("multi", "qwen3-1.7b", "t"), ("single", "jamba-1.5-large-398b", "tf")]
DEBUG = {"single": {"data": 2, "model": 2}, "multi": {"pod": 2, "data": 2, "model": 2}}


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def counted(fn, *args, mesh=None):
    with torch.no_grad(), OpAnalyzer(mesh) as a:
        fn(*args)
    return a.cost


def test_matmul_flops_exact():
    M, K, N = 128, 256, 64
    c = counted(lambda a, b: a @ b, meta(M, K), meta(K, N))
    assert (c.flops, c.bytes) == (2 * M * K * N, 4 * (M * K + K * N + M * N))


def test_a_loop_counts_every_trip():
    a = meta(128, 128)

    def loop(x):
        for _ in range(16):
            x = x @ x
        return x

    assert counted(loop, a).flops == 16 * counted(lambda x: x @ x, a).flops


def test_elementwise_flops_and_bytes():
    n = 1 << 16
    c = counted(lambda x: x * 2 + 1, meta(n))
    assert (c.flops, c.bytes) == (2 * n, 2 * 2 * 4 * n)


def test_one_row_of_a_large_tensor_does_not_bill_the_tensor():
    """A slice is a view (0 bytes); a copy of one row, a gather of it and a
    write into it move about that row."""
    big, row, idx = meta(1024, 1024), meta(1, 1024), meta(1, dtype=torch.int64)
    assert counted(lambda x: x[3:4].clone(), big).bytes == 2 * 4096
    assert counted(lambda x: x.index_select(0, idx), big).bytes == 2 * 4096 + 8
    assert counted(lambda x: x.index_put_((idx,), row), big).bytes == 2 * 4096 + 8


def test_an_all_reduce_bills_its_bytes_under_its_kind_and_axis():
    with dryrun_lib.fake_world({"data": 2, "model": 2}) as mesh:
        c = counted(lambda t: dist.all_reduce(t, group=mesh.get_group("model")), meta(256),
                    mesh=mesh)
    assert c.collectives == {"all-reduce": 1024}
    assert c.collectives_by_axis == {"model": {"all-reduce": 1024}}


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention", "ssd_scan",
                                    "flash_attention_bwd", "ssd_scan_bwd"])
def test_a_kernel_on_meta_reports_its_own_work(kernel):
    """K2 (causal pairs under a window of 30), K1 (every slot of its cache)
    and K4 (64-row chunks) on meta: empty outputs of the kernel's shapes,
    one call and the work of ``kernels.cost``, which for K2 is by hand 4 B H
    D x pairs FLOPs and q, k, v, out bytes.  Under autograd (``_bwd``) the
    forward and its backward kernel, one call each, and both their works
    (``cost.flash_bwd``: seven products over K2's pairs; ``cost.ssd`` with
    ``bwd``); the gradients empty, of their inputs' shapes."""
    B, S, H, D, N = 2, 100, 4, 32, 8
    q, kv, v, qd, clen = (meta(B, S, H, D), meta(B, S, 2, D), meta(B, S, 2, D),
                          meta(B, 3, H, D), meta(B))
    x, dt, A, Bm, C = meta(B, S, H, D), meta(B, S, H), meta(H), meta(B, S, 1, N), meta(B, S, 1, N)
    call_of = {  # k and v (B and C) apart: no gradient to sum
        "flash_attention": (lambda: [ops.flash_attention(q, kv, v, window=30)],
                            (4 * B * H * D * sum(min(i + 1, 30) for i in range(S)),
                             8 * (q.numel() + kv.numel())), [(B, S, H, D)]),
        "decode_attention": (lambda: [ops.decode_attention(qd, kv, v, clen)],
                             cost.decode(qd, kv, clen), [(B, 3, H, D)]),
        "ssd_scan": (lambda: ops.ssd_scan(x, dt, A, Bm, C), cost.ssd(x, dt, A, Bm, C),
                     [(B, S, H, D), (B, H, D, N)])}
    if kernel.endswith("_bwd"):
        call, work, _ = call_of[kernel[:-4]]
        ins = [t.requires_grad_() for t in ((q, kv, v) if "flash" in kernel else (x, dt, A, Bm, C))]
        with OpAnalyzer() as a:
            out = call()[0]
            grads = torch.autograd.grad(out, ins, torch.empty_like(out))
        bwd = cost.flash_bwd(q, kv, window=30) if len(ins) == 3 else cost.ssd(*ins, bwd=True)
        assert (a.cost.flops, a.cost.bytes, a.cost.kernels) == (*(w + b for w, b in zip(
            work, bwd, strict=True)), {kernel[:-4]: 1, kernel: 1})
        assert [g.shape for g in grads] == [t.shape for t in ins]
        return
    call, work, shapes = call_of[kernel]
    with torch.no_grad(), OpAnalyzer() as a:
        out = call()
    assert (a.cost.flops, a.cost.bytes, a.cost.kernels) == (*work, {kernel: 1})
    assert [t.shape for t in out] == shapes
    assert cost.flash(q, kv, window=30) == work if kernel == "flash_attention" else True


def test_shapes_and_cells_are_the_reference_s():
    assert configs.ASSIGNED == jax_configs.ASSIGNED
    assert ({k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.astuple(v) for k, v in jax_configs.SHAPES.items()})
    for arch in configs.ASSIGNED:
        for name in configs.SHAPES:
            assert (configs.shape_applicable(configs.get_config(arch), configs.SHAPES[name])
                    == jax_configs.shape_applicable(jax_configs.get_config(arch),
                                                    jax_configs.SHAPES[name]))


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    model = jax_build(jax_configs.get_config(arch))
    return model, jax_sharding.unzip_params(jax.eval_shape(model.init, jax.random.PRNGKey(0)))


def _reference_bytes(arch, shape_name, mesh_kind, spec_tokens=0, params_only=False):
    """Per-device bytes of the reference's step arguments, from its specs on
    its own (padded) shapes: parameters (under INFERENCE_RULES; training
    under the reference's ZeRO-1 or FSDP choice, with the optimizer state
    under DEFAULT_RULES by its ``opt_state_axes``); batch, or cache and
    tokens."""
    sizes = PRODUCTION_MESHES[mesh_kind]
    mesh = type("Mesh", (), {"shape": sizes, "axis_names": tuple(sizes)})

    def local(tree, axes, rules=jax_sharding.DEFAULT_RULES):
        leaves = jax.tree.leaves(tree)
        return sum(v.size * v.dtype.itemsize // math.prod(
            sizes[a] for e in jax_sharding.logical_to_spec(ax, mesh, rules, v.shape) if e
            for a in ((e,) if isinstance(e, str) else e))
            for v, ax in zip(leaves, jax.tree.leaves(axes, is_leaf=lambda x: isinstance(
                x, tuple) and all(a is None or isinstance(a, str) for a in x)), strict=True))

    model, (params, axes) = _jax_model(arch)
    cfg, shape = model.cfg, jax_configs.SHAPES.get(shape_name)
    fsdp = (getattr(shape, "kind", "") == "train"  # ZERO1_PARAM_RULES are INFERENCE_RULES
            and 2.0 * cfg.n_params() / sizes["model"] > jax_sharding.ZERO1_WEIGHT_BYTES_LIMIT)
    total = local(params, axes, jax_sharding.DEFAULT_RULES if fsdp else
                  jax_sharding.INFERENCE_RULES)
    if params_only:
        return total
    if shape.kind == "train":
        opt = jax.eval_shape(make_train_step(model)[0], params)
        batch = jax_dryrun.batch_specs(cfg, shape)
        # adafloor keeps a (1,) float32 placeholder for a leaf too small to
        # factor: the reference one a stacked leaf, the port one a layer
        extra = 4 * (cfg.optimizer == "adafloor") * sum(
            v.shape[0] - 1 for v in jax.tree.leaves((params["blocks"], params.get("encoder", {})))
            if v.ndim < 3 or min(v.shape[-2:]) < 128)
        return (total + local(opt, opt_state_axes(cfg.optimizer, axes, params))
                + local(batch, jax_dryrun.batch_axes(batch)) + extra)
    if shape.kind == "prefill":
        batch = jax_dryrun.batch_specs(cfg, shape)
        return total + local(batch, jax_dryrun.batch_axes(batch))
    cache = jax.eval_shape(lambda: model.init_cache(
        shape.global_batch, shape.seq_len, cfg.frontend.n_tokens if cfg.is_encdec else None))
    tokens = {"t": jax.ShapeDtypeStruct((shape.global_batch, spec_tokens + 1), "int32")}
    return (total + local(cache, jax_dryrun.cache_axes(cache))
            + local(tokens, {"t": ("batch", None)}))


TRAIN_CELLS = [(m, a, "train_4k", 0) for a in sorted(configs.ASSIGNED, key=lambda a: "jamba" not in a)
               for m in PRODUCTION_MESHES]  # the longest first
CELLS = [(m, a, s, 0) for m in PRODUCTION_MESHES for a in configs.ASSIGNED
         for s in ("prefill_32k", "decode_32k", "long_500k")] + [("single", "qwen3-1.7b",
                                                                   "decode_32k", 4)]


def _lower(cell):
    torch.set_num_threads(1)
    mesh, arch, shape, spec = cell
    return dryrun_lib.lower_cell(arch, shape, mesh, spec)


@pytest.fixture(scope="module")
def lowered():
    """Every cell of TRAIN_CELLS and CELLS, counted in four worker processes."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(4, mp_context=ctx) as pool:
        return dict(zip(TRAIN_CELLS + CELLS, pool.map(_lower, TRAIN_CELLS + CELLS), strict=True))


@pytest.mark.parametrize("mesh,arch,shape,spec", CELLS)
def test_every_serving_cell_runs_at_full_width(lowered, mesh, arch, shape, spec):
    """Each serving cell on meta at full width: ``ok``, or the reference's
    designed skip; rank 0's parameter, batch and cache bytes equal what the
    reference's specs give on its own shapes (a seamless cache also holds
    ``mem_pos``, B x M int32, which the reference's has not)."""
    res = lowered[mesh, arch, shape, spec]
    ok, why = jax_configs.shape_applicable(jax_configs.get_config(arch), jax_configs.SHAPES[shape])
    assert (res.status, res.error) == (("ok", "") if ok else ("skipped", why))
    if ok:
        extra = 0
        if arch == "seamless-m4t-large-v2" and shape != "prefill_32k":
            B = configs.SHAPES[shape].global_batch // (16 if mesh == "single" else 32)
            extra = B * configs.get_config(arch).frontend.n_tokens * 4
        assert res.argument_bytes == _reference_bytes(arch, shape, mesh, spec) + extra
        assert res.flops_per_device > 0 and res.collectives["total"] > 0


@pytest.mark.parametrize("mesh,arch,shape,spec", TRAIN_CELLS)
def test_every_training_cell_runs_at_full_width(lowered, mesh, arch, shape, spec):
    """Each ``train_4k`` cell on meta at full width: ``ok``, K2's forward
    twice a call ("minimal" remat recomputes it; jamba's "full" too) and its
    backward once; rank 0's parameter, optimizer state and batch bytes
    equal what the reference's specs give under its choice of ZeRO-1 or FSDP
    (FSDP for jamba-1.5-large-398b alone)."""
    res = lowered[mesh, arch, shape, spec]
    assert (res.status, res.error) == ("ok", "")
    assert res.argument_bytes == _reference_bytes(arch, shape, mesh)
    k2 = [res.kernels.get(k, 0) for k in ("flash_attention", "flash_attention_bwd")]
    assert k2[0] == 2 * k2[1] and res.collectives["total"] > 0


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "starcoder2-7b"])
def test_the_pad_heads_are_the_whole_gap_over_the_model_axis(arch):
    """The reference pads 40 or 36 query heads to 48; each of the port's 16
    model ranks holds the real heads among its padded slots.  Summed over the
    ranks, the port's parameter bytes fall short of 16 reference devices'
    by exactly the pad heads' ``wq``, ``wo`` (and ``bq``) bytes; rank 0
    holds as many as the reference's device."""
    class Rank:  # the (16, 16) production mesh seen from model index j
        mesh_dim_names, shape = ("data", "model"), (16, 16)

        def __init__(self, j):
            self.get_coordinate = lambda: [0, j]

    cfg = configs.get_config(arch)
    full = Model(cfg, "meta").init(0)
    axes = sharding.param_axes(full)
    per_rank = [dryrun_lib._nbytes(sharding.shard_params(
        full, axes, Rank(j), sharding.INFERENCE_RULES, cfg)) for j in range(16)]
    want = _reference_bytes(arch, None, "single", params_only=True)
    pad = (cfg.padded_heads - cfg.n_heads) * cfg.head_dim * (2 * cfg.d_model + cfg.qkv_bias)
    assert per_rank[0] == want
    assert 16 * want - sum(per_rank) == pad * cfg.n_layers * 2


REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import math
    from test_torch_dryrun import DEBUG, LOWERED, SMALL
    from repro.configs import reduced_config
    from repro.distributed import sharding as S
    from repro.launch import dryrun_lib as L, hlo_analysis as H
    from repro.models import build_model
    from repro.training.train_loop import make_train_step, opt_state_axes

    H._ELEMENTWISE = set()  # the analyzer's FLOPs then count the dots alone
    L.get_config = reduced_config
    L.SHAPES = SMALL

    def debug_mesh(multi_pod=False):  # the reference's layout hints need Auto axes
        names = ("pod", "data", "model")[0 if multi_pod else 1:]
        return jax.make_mesh((2,) * len(names), names,
                             axis_types=(jax.sharding.AxisType.Auto,) * len(names))

    L.make_production_mesh = debug_mesh

    def opt_bytes(arch, mesh):  # the reduced model's optimizer state: (whole, a device's share
        # with adafloor's placeholders one a layer, as the port keeps them)
        model = build_model(reduced_config(arch))
        params, axes = S.unzip_params(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
        opt = jax.eval_shape(make_train_step(model)[0], params)
        share = 4 * (model.cfg.optimizer == "adafloor") * sum(
            v.shape[0] - 1 for v in jax.tree.leaves(params["blocks"])
            if v.ndim < 3 or min(v.shape[-2:]) < 128)
        sizes = DEBUG[mesh]
        fake = type("Mesh", (), {"shape": sizes, "axis_names": tuple(sizes)})
        for v, ax in zip(jax.tree.leaves(opt), jax.tree.leaves(
                opt_state_axes(model.cfg.optimizer, axes, params), is_leaf=lambda x: isinstance(
                    x, tuple) and all(a is None or isinstance(a, str) for a in x))):
            spec = S.logical_to_spec(ax, fake, S.DEFAULT_RULES, v.shape)
            share += v.size * v.dtype.itemsize // math.prod(
                sizes[a] for e in spec if e for a in ((e,) if isinstance(e, str) else e))
        return sum(v.size * v.dtype.itemsize for v in jax.tree.leaves(opt)), share

    out = {}
    for m, a, s in LOWERED:
        S.ZERO1_WEIGHT_BYTES_LIMIT = 0 if s == "tf" else 8e9  # "tf": FSDP forced
        r = L.lower_cell(a, s, m)
        out[f"{m} {a} {s}"] = [r.flops_per_device, r.argument_bytes, r.collectives,
                               opt_bytes(a, m) if s in ("t", "tf") else None]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module", autouse=True)
def reference_started():
    """The reference's lowering, started with the module's first test so
    that it runs beside the cells."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    yield proc
    proc.kill()


@pytest.fixture(scope="module")
def reference_lowering(reference_started):
    out, err = reference_started.communicate(timeout=600)
    assert reference_started.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh,arch,shape", LOWERED)
def test_lowering_matches_the_reference_on_debug_meshes(reference_lowering, monkeypatch, mesh,
                                                        arch, shape):
    """The reduced model on a (2, 2) or (2, 2, 2) mesh: argument bytes
    exactly the reference's; its matmul family's FLOPs (the kernels'
    products with them) within 10% of the reference's dot FLOPs.  The
    collective bytes are printed beside each other, not held: GSPMD chooses
    its own.  A training step's compiled arguments hold the optimizer state
    whole (``tree_specs`` takes the ``AdamWState`` / ``AdafloorState`` tuple
    for one leaf: ROADMAP §3), where the port holds its share under
    DEFAULT_RULES: exactly that difference apart (with adafloor's per-layer
    placeholders, as ``_reference_bytes`` counts them)."""
    ref_flops, ref_args, ref_coll, opt = reference_lowering[f"{mesh} {arch} {shape}"]
    if opt is not None:  # (whole, the share DEFAULT_RULES gives by opt_state_axes)
        ref_args += opt[1] - opt[0]
    monkeypatch.setattr(sharding, "ZERO1_WEIGHT_BYTES_LIMIT", 0 if shape == "tf" else 8e9)
    res = dryrun_lib.lower_cell(arch, shape, mesh, cfg=configs.reduced_config(arch),
                                shape=SMALL[shape], sizes=DEBUG[mesh])
    print(f"{mesh} {arch} {shape}: matmul FLOPs {res.matmul_flops_per_device / ref_flops:.4f} "
          f"of the reference's dots; collective bytes {res.collectives} (port), {ref_coll} "
          f"(reference)")
    assert res.argument_bytes == ref_args
    assert abs(res.matmul_flops_per_device / ref_flops - 1) <= 0.10, (res.matmul_flops_per_device,
                                                                      ref_flops)
