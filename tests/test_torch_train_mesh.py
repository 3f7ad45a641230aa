"""Training under a mesh across processes: four CPU ranks (gloo, one torch
thread each) run two training steps of each case on their shards, beside
one JAX subprocess with four host devices that runs the reference's
``make_train_step`` jitted with ``dryrun_lib``'s shardings inside ``with
mesh, use_rules(rules)``, as ``dryrun_lib.lower_cell`` builds a ``train_4k``
cell (FSDP forced by setting ``ZERO1_WEIGHT_BYTES_LIMIT`` to 0 in that
subprocess).  Both start from the reference's init through the weight
bridge, in fp32, with the same numpy batch.

Each step's loss and grad norm, each rank's gradient shards (on the
optimizer's shard, after the reduction over the batch axes) and parameter
shards against their place in the reference's global arrays, and the MoE
layer's keep masks against the reference's ``_sort_rank`` on the same
routing.  A step without a mesh is bit-equal to its two halves (``grads``,
``update``) joined by hand.

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_mesh.py
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _one_torch_thread  # noqa: F401

from repro.models.moe import _sort_rank
from repro_torch.configs import reduced_config
from repro_torch.distributed import sharding
from repro_torch.models.model import Model
from repro_torch.params import from_jax_tree, tree_items, tree_map
from repro_torch.training.optimizer import apply_updates, make_optimizer
from repro_torch.training.train_loop import make_train_step

ROOT = Path(__file__).resolve().parents[1]
# case: (arch, (data, model), FSDP forced)
CASES = {"qwen3 zero1 2x2": ("qwen3-1.7b", (2, 2), False),
         "qwen3 zero1 1x4": ("qwen3-1.7b", (1, 4), False),
         "qwen3 fsdp 2x2": ("qwen3-1.7b", (2, 2), True),
         "mamba2 zero1 2x2": ("mamba2-2.7b", (2, 2), False),
         "qwen3-moe 2x2": ("qwen3-moe-30b-a3b", (2, 2), False),
         "jamba fsdp 2x2": ("jamba-1.5-large-398b", (2, 2), True),
         "seamless 2x2": ("seamless-m4t-large-v2", (2, 2), False)}
ROWS, S, STEPS, PARTS = 4, 24, 2, 4
STEP_TOL = 1e-2  # a step's change to a parameter shard, relative to the reference's, in norm


def port_cfg(case):
    return dataclasses.replace(reduced_config(CASES[case][0]), n_layers=2, dtype="float32")


REFERENCE = textwrap.dedent("""
    # The reference's GSPMD train step on four host devices, two steps a
    # case: each step's gradients, parameters after it, loss and grad norm;
    # every PARTS-th case from the given one (PARTS processes side by side).
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_llvm_disable_expensive_passes=true")
    os.environ["REPRO_FORCE_REF_KERNELS"] = "1"  # as lower_cell sets it
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed import sharding as S
    from repro.launch import dryrun_lib as L
    from repro.models import build_model
    from repro.training.optimizer import OptConfig
    from repro.training.train_loop import make_train_step, opt_state_axes
    from repro.configs import reduced_config
    from test_torch_train_mesh import CASES, PARTS, ROWS, STEPS, S as SEQ
    from test_torch_model import nonzero_biases

    run, part, out = sys.argv[1], int(sys.argv[2]), {}
    for case, (arch, shape, fsdp) in list(CASES.items())[part::PARTS]:
        cfg = dataclasses.replace(reduced_config(arch), n_layers=2, dtype="float32")
        model = build_model(cfg)
        tree = nonzero_biases(jax.tree.map(np.asarray, S.unzip_params(model.init(
            jax.random.PRNGKey(0)))[0]))  # the weights of test_torch_model.model_pair
        # numpy tokens, the first row one token throughout (its tokens route
        # alike, so the MoE layer drops at capacity 1.25); 16 frames a row
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)}
        batch["tokens"][0] = 7
        if cfg.is_encdec:
            batch["frames"] = rng.normal(size=(ROWS, 16, cfg.d_model)).astype(np.float32)
        pickle.dump((tree, batch), open(f"{run}/{case}.tmp", "wb"))
        os.rename(f"{run}/{case}.tmp", f"{run}/{case}.pkl")  # for the ranks
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        S.ZERO1_WEIGHT_BYTES_LIMIT = 0 if fsdp else 8e9
        zero1 = 2.0 * cfg.n_params() / mesh.shape["model"] <= S.ZERO1_WEIGHT_BYTES_LIMIT
        rules = S.ZERO1_PARAM_RULES if zero1 else S.DEFAULT_RULES
        axes = S.unzip_params(jax.eval_shape(model.init, jax.random.PRNGKey(0)))[1]
        params, batch = jax.tree.map(jnp.asarray, (tree, batch))
        with mesh, S.use_rules(rules):
            init_opt, train_step = make_train_step(model, OptConfig())
            opt = init_opt(params)
            shard = (L._shardings(axes, params, mesh, rules),
                     L._shardings(opt_state_axes(cfg.optimizer, axes, params), opt, mesh),
                     L._shardings(L.batch_axes(batch), batch, mesh))

            def both(p, o, b):
                return jax.grad(lambda p: model.loss_fn(p, b)[0])(p), train_step(p, o, b)

            fn, steps = jax.jit(both, in_shardings=shard), []
            for _ in range(STEPS):
                grads, (params, opt, m) = fn(params, opt, batch)
                params, opt = jax.device_put((params, opt), shard[:2])
                steps.append(jax.tree.map(np.asarray, (grads, params, {
                    k: m[k] for k in ("loss", "grad_norm")})))
        out[case] = tree, steps
    pickle.dump(out, open(f"{run}/reference{part}.pkl", "wb"))
""")

RANKS = textwrap.dedent("""
    # One of the four ranks: two steps of every case on its shards, under
    # the mesh; writes out<rank>.pkl: each step's loss, grad norm, gradient
    # and parameter shards, and the MoE layer's (assignments, C, keep).
    import os, pickle, sys, time
    import torch
    import torch.distributed as dist
    from test_torch_train_mesh import CASES, STEPS, port_cfg
    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.params import from_jax_tree, tree_items
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import make_train_step

    rank, run = sys.argv[1:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{run}/rendezvous", rank=int(rank),
                            world_size=4)
    ranked, sort_rank = [], moe.sort_rank

    def record(flat_e, C):
        out = sort_rank(flat_e, C)
        ranked.append((flat_e.numpy().copy(), C, out[3].numpy().copy()))
        return out

    moe.sort_rank = record
    meshes, out = {}, {}
    for case, (arch, shape, fsdp) in CASES.items():
        cfg = port_cfg(case)
        while not os.path.exists(f"{run}/{case}.pkl"):  # the reference writes it
            time.sleep(0.05)
        tree, batch = pickle.load(open(f"{run}/{case}.pkl", "rb"))
        if shape not in meshes:
            meshes[shape] = sharding.make_mesh(shape, device="cpu")
        mesh, ranked[:] = meshes[shape], []
        i = mesh.get_coordinate()[0]
        sharding.ZERO1_WEIGHT_BYTES_LIMIT = 0 if fsdp else 8e9
        zero1 = 2.0 * cfg.n_params() / shape[1] <= sharding.ZERO1_WEIGHT_BYTES_LIMIT
        rules = sharding.ZERO1_PARAM_RULES if zero1 else sharding.DEFAULT_RULES
        params = from_jax_tree(tree, cfg)
        local = sharding.shard_params(params, sharding.param_axes(params), mesh, rules, cfg)
        rows = slice(i * len(batch["tokens"]) // shape[0], (i + 1) * len(batch["tokens"]) // shape[0])
        mine = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        steps = []
        with sharding.use_mesh(mesh), sharding.use_rules(rules):
            init_opt, train_step = make_train_step(Model(cfg, "cpu"), OptConfig())
            opt = init_opt(local)
            for _ in range(STEPS):
                _, m, grads = train_step.grads(local, mine)
                g = [x.numpy().copy() for _, x in tree_items(grads)]
                local, opt, m = train_step.update(local, opt, grads, m)
                steps.append((float(m["loss"]), float(m["grad_norm"]), g,
                              [x.numpy().copy() for _, x in tree_items(local)]))
        out[case] = steps, list(ranked), tuple(mesh.get_coordinate())
    pickle.dump(out, open(f"{run}/out{rank}.pkl", "wb"))
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's steps a case, each rank's results)."""
    run = tmp_path_factory.mktemp("train_mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    procs = [subprocess.Popen([sys.executable, "-c", script, *args], env=env,
                              stderr=subprocess.PIPE, text=True)
             for script, args in [(REFERENCE, [str(run), str(i)]) for i in range(PARTS)]
             + [(RANKS, [str(r), str(run)]) for r in range(4)]]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs, strict=True):
        assert p.returncode == 0, err[-3000:]
    return ({k: v for i in range(PARTS) for k, v in pickle.load(
        open(run / f"reference{i}.pkl", "rb")).items()},
            [pickle.load(open(run / f"out{r}.pkl", "rb")) for r in range(4)])


def _leaves(tree, cfg, rules=None, shape=None, coord=None):
    """A reference tree's leaves in the port's layout: whole, or under
    ``rules`` the shards of the rank at ``coord`` of a (data, model) mesh of
    ``shape`` (as ``shard_params`` reads a DeviceMesh)."""
    whole = from_jax_tree(tree, cfg)
    if rules is not None:
        rank = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape,
                                     get_coordinate=lambda: list(coord))
        whole = sharding.shard_params(whole, sharding.param_axes(whole), rank, rules, cfg)
    return [w.numpy() for _, w in tree_items(whole)]


@pytest.mark.parametrize("case", list(CASES))
def test_training_under_a_mesh_matches_the_reference_gspmd_step(runs, case):
    """Two fp32 steps: loss and grad norm within 1e-5; each rank's gradient
    shards within 1e-4 x max |g| of the leaf and its parameter shards within
    1e-4 (MoE 2e-4, AdamW's eps: ROADMAP §3 item 9) of their place in the
    reference's global arrays; the change a step makes to each parameter
    shard (a few 1e-6 in warmup, far under those limits) within STEP_TOL of
    the reference's change in norm; a MoE layer's keep masks equal to the
    reference's ranking of the same assignments, with drops."""
    want, outs = runs
    cfg, shape = port_cfg(case), CASES[case][1]
    tree, ref_steps = want[case]
    rules = sharding.DEFAULT_RULES if CASES[case][2] else sharding.ZERO1_PARAM_RULES
    for r, out in enumerate(outs):
        steps, ranked, coord = out[case]
        was = ref_was = _leaves(tree, cfg, rules, shape, coord)
        for s, ((loss, norm, grads, params), (rg, rp, rm)) in enumerate(
                zip(steps, ref_steps, strict=True)):
            tag = f"{case} rank {r} step {s}"
            np.testing.assert_allclose([loss, norm], [rm["loss"], rm["grad_norm"]], rtol=1e-5,
                                       atol=1e-5, err_msg=tag)
            tols = [1e-4 * np.abs(g).max() for g in _leaves(rg, cfg)]
            tols += [2e-4 if cfg.moe else 1e-4] * len(params)
            ref_params = _leaves(rp, cfg, rules, shape, coord)
            for got, ref, tol in zip(grads + params, _leaves(rg, cfg, sharding.DEFAULT_RULES, shape,
                                                             coord) + ref_params, tols, strict=True):
                np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=tag)
            for now, then, ref, ref_then in zip(params, was, ref_params, ref_was, strict=True):
                change = ref - ref_then
                assert np.linalg.norm(now - then - change) <= STEP_TOL * np.linalg.norm(change), tag
            was, ref_was = params, ref_params
        assert "moe" not in case or not all(keep.all() for _, _, keep in ranked)  # drops
        for flat_e, C, keep in ranked:
            np.testing.assert_array_equal(keep, np.asarray(
                _sort_rank(jnp.asarray(flat_e), len(flat_e), C)[3]))


def test_a_step_without_a_mesh_is_the_step_without_the_mesh_code():
    """A step of ``make_train_step`` without a mesh against loss_fn, autograd
    and the optimizer joined by hand: the same bits.  This holds only the
    split of the step into ``grads`` and ``update``; the step itself is held
    to the reference's by the JAX-parity tests (``test_torch_train.py``,
    ``test_torch_train_families.py``, ``test_torch_hybrid.py``: five steps
    each)."""
    tm = Model(port_cfg("qwen3 zero1 2x2"), "cpu")
    want = tm.init(0)
    batch = {"tokens": torch.randint(0, 512, (ROWS, S), generator=torch.Generator().manual_seed(0))}
    init_opt, train_step = make_train_step(tm)
    got = train_step(tree_map(torch.clone, want), init_opt(want), batch)
    opt_init, opt_update = make_optimizer(tm.cfg.optimizer)
    live = tree_map(lambda p: p.detach().requires_grad_(), want)
    loss, want_m = tm.loss_fn(live, batch)
    grads = iter(torch.autograd.grad(loss, [p for _, p in tree_items(live)]))
    updates, want_opt, opt_m = opt_update(tree_map(lambda _: next(grads), want), opt_init(want),
                                          want)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(got), tree_items(
        (apply_updates(want, updates), want_opt, {**want_m, **opt_m})), strict=True))
