"""Resilient training under a mesh across processes: int8 gradient
compression on the optimizer's shards and checkpoints that restore onto
another mesh.  Four CPU ranks (gloo, one torch thread each) beside one JAX
subprocess with four host devices that runs the reference's jitted GSPMD
train step with ``GradientCompressor`` under ``dryrun_lib``'s shardings (as
``tests/test_torch_train_mesh.py`` does without compression), in fp32 from
the reference's init through the weight bridge, on the same numpy batch.

* Each case's steps held from the reference's state (parameters, AdamW
  moments and error tree cut to the rank's pieces), step by step.
* The first case's ranks then save a checkpoint; it restores onto (1, 4),
  under FSDP, in a 2-rank world and without a mesh, and each continues
  beside the reference restored onto the same mesh (``device_put`` under
  its shardings).
* ``TrainSupervisor`` with a failure on every rank against the
  uninterrupted run; and, in this process, the compressor's choice of
  leaves by the reference's stacks against the reference's compressor.

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_elastic.py
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_engine import _one_torch_thread  # noqa: F401

from repro.configs import reduced_config as jax_reduced
from repro.distributed import sharding as jax_sharding
from repro.distributed.compression import GradientCompressor as JaxCompressor
from repro.training.checkpoint import CheckpointManager as JaxCheckpoints
from repro.models import build_model
from repro_torch.configs import reduced_config
from repro_torch.distributed.compression import GradientCompressor, compression_plan
from repro_torch.params import from_jax_tree, tree_items
from repro_torch.training.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
# case: (arch, (data, model), FSDP forced)
CASES = {"qwen3 zero1 2x2": ("qwen3-1.7b", (2, 2), False),
         "qwen3 zero1 1x4": ("qwen3-1.7b", (1, 4), False),
         "qwen3 fsdp 2x2": ("qwen3-1.7b", (2, 2), True),
         "mamba2 zero1 2x2": ("mamba2-2.7b", (2, 2), False),
         "qwen3-moe 2x2": ("qwen3-moe-30b-a3b", (2, 2), False)}
# the first case's checkpoint restored: name -> ((data, model) or None, FSDP forced, the ranks)
RESTORES = {"zero1 1x4": ((1, 4), False, range(4)), "fsdp 2x2": ((2, 2), True, range(4)),
            "2 ranks 2x1": ((2, 1), False, range(2)), "no mesh": (None, False, [2])}
ROWS, S, STEPS, MORE = 4, 24, 2, 2
STEP_TOL = 1e-2  # as tests/test_torch_train_mesh.py's


def port_cfg(arch):
    return dataclasses.replace(reduced_config(arch), n_layers=2, dtype="float32")


REFERENCE = textwrap.dedent("""
    # The reference's compressed GSPMD step on four host devices: STEPS steps
    # a case from its init (each state, the step's metrics and each
    # gradient's quantum max |g + e| / 127), the first case's checkpoint,
    # and its restores onto RESTORES' meshes, MORE steps each.
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_llvm_disable_expensive_passes=true")
    os.environ["REPRO_FORCE_REF_KERNELS"] = "1"  # as lower_cell sets it
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed import sharding as S
    from repro.distributed.compression import GradientCompressor
    from repro.launch import dryrun_lib as L
    from repro.models import build_model
    from repro.training.checkpoint import CheckpointManager
    from repro.training.optimizer import OptConfig
    from repro.training.train_loop import make_train_step, opt_state_axes
    from repro.configs import reduced_config
    from test_torch_train_elastic import CASES, MORE, RESTORES, ROWS, STEPS, S as SEQ
    from test_torch_engine import nonzero_biases

    run, fns, out = sys.argv[1], {}, {}
    host = lambda t: jax.tree.map(np.asarray, t)

    def compiled(model, cfg, shape, fsdp, params, batch):
        # the jitted step and its shardings under a (data, model) mesh of
        # shape (none for None), kept for each layout
        key = (cfg.name, shape, fsdp)
        if key in fns:
            return fns[key]
        mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:np.prod(shape)],
                             axis_types=(jax.sharding.AxisType.Auto,) * 2) if shape else None
        S.ZERO1_WEIGHT_BYTES_LIMIT = 0 if fsdp else 8e9
        zero1 = 2.0 * cfg.n_params() / (shape or (1, 1))[1] <= S.ZERO1_WEIGHT_BYTES_LIMIT
        rules = S.ZERO1_PARAM_RULES if zero1 else S.DEFAULT_RULES
        axes = S.unzip_params(jax.eval_shape(model.init, jax.random.PRNGKey(0)))[1]
        init_opt, train_step = make_train_step(model, OptConfig(), GradientCompressor())
        opt = init_opt(params)

        def both(p, o, b):  # the step, and each gradient's quantum where it is compressed
            g = jax.grad(lambda p: model.loss_fn(p, b)[0])(p)
            quanta = jax.tree.map(lambda g, e: jnp.broadcast_to(jnp.maximum(
                jnp.max(jnp.abs(g + e), -1, keepdims=True) / 127.0, 1e-12), g.shape) * (
                g.size >= 4096), g, o[1])
            return quanta, train_step(p, o, b)

        if mesh is None:
            fns[key] = jax.jit(both), None, None
            return fns[key]
        with mesh, S.use_rules(rules):
            shard = (L._shardings(axes, params, mesh, rules),
                     (L._shardings(opt_state_axes(cfg.optimizer, axes, params), opt[0], mesh),
                      L._shardings(axes, params, mesh)),
                     L._shardings(L.batch_axes(batch), batch, mesh))
        fns[key] = jax.jit(both, in_shardings=shard), shard, (mesh, rules)
        return fns[key]

    def steps(model, cfg, shape, fsdp, state, batch, n):
        # n steps from state: [(state after, quanta, metrics)]
        fn, shard, ctx = compiled(model, cfg, shape, fsdp, state[0], batch)
        put = (lambda t, s: jax.device_put(t, s)) if shard else (lambda t, s: t)
        state, batch, res = put(state, shard and shard[:2]), put(batch, shard and shard[2]), []
        for _ in range(n):
            if ctx:
                with ctx[0], S.use_rules(ctx[1]):
                    quanta, (p, o, m) = fn(*state, batch)
            else:
                quanta, (p, o, m) = fn(*state, batch)
            state = put((p, o), shard and shard[:2])
            res.append((host(state), host(quanta), {k: float(m[k]) for k in
                                                     ("loss", "grad_norm", "lr")}))
        return res

    for case, (arch, shape, fsdp) in CASES.items():
        cfg = dataclasses.replace(reduced_config(arch), n_layers=2, dtype="float32")
        model = build_model(cfg)
        tree = nonzero_biases(host(S.unzip_params(model.init(jax.random.PRNGKey(0)))[0]))
        rng = np.random.default_rng(0)  # the first row one token throughout (MoE drops)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)}
        batch["tokens"][0] = 7
        params, jbatch = jax.tree.map(jnp.asarray, (tree, batch))
        opt = make_train_step(model, OptConfig(), GradientCompressor())[0](params)
        done = [(host((params, opt)), None, None)] + steps(model, cfg, shape, fsdp,
                                                           (params, opt), jbatch, STEPS)
        pickle.dump((batch, done), open(f"{run}/{case}.tmp", "wb"))
        os.rename(f"{run}/{case}.tmp", f"{run}/{case}.pkl")  # for the ranks
        out[case] = done
        if case == next(iter(CASES)):  # its checkpoint, and restores onto other meshes
            (p, (o, e)) = done[-1][0]
            ck = CheckpointManager(f"{run}/reference_ckpt")
            ck.save(STEPS, {"params": p, "opt": o, "err": e})
            for name, (shape, fsdp, _) in RESTORES.items():
                _, back = ck.restore({"params": p, "opt": o, "err": e})
                state = jax.tree.map(jnp.asarray, (back["params"], (back["opt"], back["err"])))
                out[name] = steps(model, cfg, shape, fsdp, state, jbatch, MORE)
    pickle.dump(out, open(f"{run}/reference.pkl", "wb"))
""")

RANKS = textwrap.dedent("""
    # One of the four ranks: every case's steps held from the reference's
    # states; the first case's checkpoint; its restores; the supervisor's
    # run with a failure.  Writes out<rank>.pkl.
    import contextlib, datetime, os, pickle, sys, time
    import torch
    import torch.distributed as dist
    from test_torch_train_elastic import CASES, MORE, RESTORES, STEPS, port_cfg
    from repro_torch.distributed import sharding
    from repro_torch.distributed.compression import GradientCompressor
    from repro_torch.distributed.fault_tolerance import TrainSupervisor
    from repro_torch.models.model import Model
    from repro_torch.params import from_jax_tree, from_reference_state, tree_items, tree_map
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import make_train_step

    rank, run = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{run}/rendezvous", rank=rank,
                            world_size=4, timeout=datetime.timedelta(seconds=300))
    meshes, out = {}, {}

    def whole_state(cfg, state):
        # the reference's (params, (AdamWState, error)) in the port's layout
        p, (o, e) = state
        flat = {f"params/{k}": v for k, v in tree_items(p)}
        flat.update({f"opt/{k}": v for k, v in tree_items(o)})
        params, opt = from_reference_state(flat, cfg)
        return params, [x for _, x in tree_items(opt)] + [x for _, x in tree_items(
            from_jax_tree(e, cfg))]

    def cut(x, starts, like):
        return x[tuple(slice(a, a + n) for a, n in zip(starts, like.shape))].clone()

    def setup(arch, shape, fsdp):
        # (model, mesh or None, rules) for shape (None: no mesh)
        cfg = port_cfg(arch)
        sharding.ZERO1_WEIGHT_BYTES_LIMIT = 0 if fsdp else 8e9
        zero1 = 2.0 * cfg.n_params() / (shape or (1, 1))[1] <= sharding.ZERO1_WEIGHT_BYTES_LIMIT
        rules = sharding.ZERO1_PARAM_RULES if zero1 else sharding.DEFAULT_RULES
        if shape is not None and shape not in meshes:
            meshes[shape] = sharding.make_mesh(shape, device="cpu")
        return Model(cfg, "cpu"), shape and meshes[shape], rules

    def under(mesh, rules):
        stack = contextlib.ExitStack()
        if mesh is not None:
            stack.enter_context(sharding.use_mesh(mesh))
            stack.enter_context(sharding.use_rules(rules))
        return stack

    def rows(batch, mesh):
        if mesh is None:
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        (i, _), n = mesh.get_coordinate(), mesh.shape[0]
        return {k: torch.from_numpy(v[i * len(v) // n:(i + 1) * len(v) // n])
                for k, v in batch.items()}

    def shards(params, opt):
        return ({k: x.clone() for k, x in tree_items(params)},
                [x.clone() for _, x in tree_items(opt)])

    def held(case):
        # each step from the reference's state: (places, [(metrics, params, opt)])
        arch, shape, fsdp = CASES[case]
        while not os.path.exists(f"{run}/{case}.pkl"):  # the reference writes it
            time.sleep(0.05)
        batch, done = pickle.load(open(f"{run}/{case}.pkl", "rb"))
        model, mesh, rules = setup(arch, shape, fsdp)
        res = []
        with under(mesh, rules):
            init_opt, step = make_train_step(model, OptConfig(), GradientCompressor())
            for state, _, _ in done[:-1]:
                whole, opt_whole = whole_state(model.cfg, state)
                params = sharding.shard_params(whole, sharding.param_axes(whole), mesh, rules,
                                               model.cfg)
                places = step.places(params)
                it = iter(zip(opt_whole, places["opt"]))
                opt = tree_map(lambda t: cut(*next(it), t), init_opt(params))
                params, opt, m = step(params, opt, rows(batch, mesh))
                res.append(({k: float(v) for k, v in m.items()}, *shards(params, opt)))
        return places, res, (model, mesh, rules, step, params, opt, batch)

    def matches(leaves, trees, places):
        # every leaf of trees equal to its slice of the checkpoint's whole leaf
        return all(torch.equal(x, leaves[f"{g}/{k}"] if places is None else cut(
            leaves[f"{g}/{k}"], a, x)) for g, t in trees.items() for (k, x), a in zip(
                tree_items(t), places[g] if places else [None] * len(tree_items(t)), strict=True))

    def restore(ck, name):
        # the checkpoint onto RESTORES[name]: (shards equal to slices of its
        # whole leaves, places, each of MORE steps' metrics, the shards after)
        shape, fsdp, _ = RESTORES[name]
        model, mesh, rules = setup("qwen3-1.7b", shape, fsdp)
        with under(mesh, rules):
            init_opt, step = make_train_step(model, OptConfig(), GradientCompressor())
            params = model.init(0)
            if mesh is not None:
                params = sharding.shard_params(params, sharding.param_axes(params), mesh, rules,
                                               model.cfg)
            places = step.places(params)
            _, back = ck.restore({"params": params, "opt": init_opt(params)}, places=places)
            exact = matches(ck.read()[1], back, places)
            params, opt, res = back["params"], back["opt"], []
            for _ in range(MORE):
                params, opt, m = step(params, opt, rows(batch, mesh))
                res.append({k: float(v) for k, v in m.items()})
        return exact, places, res, shards(params, opt)

    def supervised(model, mesh, rules, fail_at):
        # TrainSupervisor: five steps, a checkpoint every two, every rank
        # failing once at fail_at: (restarts, losses, the shards after)
        with under(mesh, rules):
            init_opt, step = make_train_step(model, OptConfig(), GradientCompressor())
            params = model.init(0)
            params = sharding.shard_params(params, sharding.param_axes(params), mesh, rules,
                                           model.cfg)
            state, losses = {"params": params, "opt": init_opt(params)}, []
            ck, armed = CheckpointManager(f"{run}/supervised{fail_at}"), [fail_at]

            def run_step(n):
                if n == armed[0]:
                    armed[0] = -1
                    raise RuntimeError(f"injected failure at step {n}")
                state["params"], state["opt"], m = step(state["params"], state["opt"],
                                                        rows(batch, mesh))
                losses.append(float(m["loss"]))

            def save(n):
                ck.save(n, {**state, "meta": {}}, places=step.places(state["params"]))

            def restore_latest():
                if ck.latest_step() is None:
                    save(0)
                    return 0
                n, back = ck.restore({**state, "meta": {}}, places=step.places(state["params"]))
                state.update(params=back["params"], opt=back["opt"])
                return n

            report = TrainSupervisor(run_step, save, restore_latest, checkpoint_every=2).run(5)
            return report.restarts, losses, shards(state["params"], state["opt"])

    for case in CASES:
        places, res, last = held(case)
        out[case] = places, res
        if case == next(iter(CASES)):  # its checkpoint, the restores, the supervisor
            model, mesh, rules, step, params, opt, batch = last
            ck = CheckpointManager(f"{run}/ckpt")
            with under(mesh, rules):
                ck.save(STEPS, {"params": params, "opt": opt, "meta": {"step": STEPS}},
                        places=places)
            _, leaves, meta = ck.read()
            out["saved"] = meta == {"step": STEPS} and matches(
                leaves, {"params": params, "opt": opt}, places)
            out.update((name, restore(ck, name)) for name, (_, _, ranks) in RESTORES.items()
                       if len(ranks) == 4)
            out["supervised"] = [supervised(model, mesh, rules, at) for at in (-1, 3)]
    dist.destroy_process_group()
    if rank < 2:  # a 2-rank world
        dist.init_process_group("gloo", init_method=f"file://{run}/rendezvous2", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=300))
        out["2 ranks 2x1"] = restore(ck, "2 ranks 2x1")
        dist.destroy_process_group()
    elif rank == 2:
        out["no mesh"] = restore(ck, "no mesh")
    pickle.dump(out, open(f"{run}/out{rank}.pkl", "wb"))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results, each rank's)."""
    run = tmp_path_factory.mktemp("train_elastic")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    procs = [subprocess.Popen([sys.executable, "-c", script, *args], env=env,
                              stderr=subprocess.PIPE, text=True)
             for script, args in [(REFERENCE, [str(run)])]
             + [(RANKS, [str(r), str(run)]) for r in range(4)]]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs, strict=True):
        assert p.returncode == 0, err[-3000:]
    return (pickle.load(open(run / "reference.pkl", "rb")),
            [pickle.load(open(run / f"out{r}.pkl", "rb")) for r in range(4)], run)


def _cut(x, starts, like):
    return x[tuple(slice(a, a + n) for a, n in zip(starts, like.shape, strict=True))]


def _whole(tree, cfg):
    """A reference tree (numpy) in the port's layout: {path: tensor}."""
    return dict(tree_items(from_jax_tree(tree, cfg)))


def _hold(cfg, got, places, state, quanta, lr, tag, was=None):
    """A rank's parameter shards (by path) and error pieces, ``got``, against
    the reference's state (parameters, (optimizer state, error tree)) at
    their ``places``, with the held limits of
    ``test_five_compressed_training_steps_match_jax``: parameters within
    1e-4 (MoE 2e-4, AdamW's eps) and errors within 1e-6, but at the entries
    a rounding flip moved (at most 1e-3 of them), where within 2 lr + 1e-4
    and one quantum of the row + 1e-6.  With ``was`` (the reference's
    parameters before the step), away from the flips the change the step
    made to the rank's optimizer piece within STEP_TOL of the reference's, in
    norm (one flip is a change of up to lr at one entry: at (1, 4) a piece
    of wq is 4,096 entries, and one flip there moves its change by 1.6e-2)."""
    params, errs = got
    ref, err, q = (_whole(t, cfg) for t in (state[0], state[1][1], quanta))
    past = size = 0
    for (k, x), a, e, b in zip(params.items(), places["params"], errs,
                               places["opt"][-len(params):], strict=True):
        d, de = (x - _cut(ref[k], a, x)).abs(), (e - _cut(err[k], b, e)).abs()
        assert bool((d <= 2 * lr + 1e-4).all() and (de <= _cut(q[k], b, e) + 1e-6).all()), (tag, k)
        past += int((d > (2e-4 if cfg.moe else 1e-4)).sum() + (de > 1e-6).sum())
        size += x.numel() + e.numel()
        if was is not None:
            mine, theirs = (_cut(t - _cut(was[k], a, x), [j - i for i, j in zip(a, b)], e) * (
                de <= 1e-6) for t in (x, _cut(ref[k], a, x)))
            assert (mine - theirs).norm() <= STEP_TOL * theirs.norm(), (tag, k)
    assert past <= 1e-3 * size, (tag, past)


def _metrics_close(got, want, norm_tol, what):
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm", "lr")}
    assert rel["loss"] <= 1e-5 and rel["lr"] <= 1e-6 and rel["grad_norm"] <= norm_tol, (what, rel)


@pytest.mark.parametrize("case", list(CASES))
def test_compressed_steps_under_a_mesh_match_the_reference_gspmd_step(runs, case):
    """Each step from the reference's state, with the held limits of
    ``test_five_compressed_training_steps_match_jax``: loss and lr within
    1e-5 and 1e-6, grad norm 1e-5 (relative), and ``_hold``'s on every
    rank's shards, with each step's change."""
    want, outs, _ = runs
    cfg, done = port_cfg(CASES[case][0]), want[case]
    for s, ((then, _, _), (now, quanta, m)) in enumerate(zip(done[:-1], done[1:], strict=True)):
        was = _whole(then[0], cfg)
        for r, out in enumerate(outs):
            places, res = out[case]
            metrics, params, opt = res[s]
            _metrics_close(metrics, m, 1e-5, f"{case} rank {r} step {s}")
            _hold(cfg, (params, opt[-len(params):]), places, now, quanta, m["lr"],
                  f"{case} rank {r} step {s}", was)


def test_a_checkpoint_under_a_mesh_holds_whole_arrays(runs):
    """The first case's checkpoint, saved by its four ranks at (2, 2): whole
    arrays, each rank's shards bit-equal to their slices, and within
    ``_hold``'s limits of the reference's ``CheckpointManager`` files at the
    same step (parameters and error tree), through the weight bridge."""
    want, outs, run = runs
    assert all(out["saved"] for out in outs)
    case = next(iter(CASES))
    cfg, ((p, (o, e)), quanta, m) = port_cfg(CASES[case][0]), want[case][-1]
    _, got, meta = CheckpointManager(run / "ckpt").read()
    _, ref = JaxCheckpoints(run / "reference_ckpt").restore({"params": p, "opt": o, "err": e})
    assert meta == {"step": STEPS} and int(got["opt/0/step"]) == int(ref["opt"].step) == STEPS
    keys = list(_whole(p, cfg))
    zeros = [(0,) * got[f"params/{k}"].dim() for k in keys]
    _hold(cfg, ({k: got[f"params/{k}"] for k in keys}, [got[f"opt/1/{k}"] for k in keys]),
          {"params": zeros, "opt": zeros}, (ref["params"], (ref["opt"], ref["err"])), quanta,
          m["lr"], "checkpoint")


@pytest.mark.parametrize("name", list(RESTORES))
def test_the_checkpoint_restores_onto_another_mesh(runs, name):
    """The checkpoint restored onto another mesh shape, world size or no
    mesh: each rank's shards bit-equal to slices of its whole arrays; then
    MORE steps against the reference restored from its own checkpoint onto
    the same mesh, with the limits of the free compressed run (loss 1e-5,
    lr 1e-6, grad norm 1e-4 relative; parameters within one lr)."""
    want, outs, _ = runs
    cfg = port_cfg("qwen3-1.7b")
    for r in RESTORES[name][2]:
        exact, places, res, (params, _) = outs[r][name]
        assert exact, (name, r)
        for s, (metrics, (_, _, m)) in enumerate(zip(res, want[name], strict=True)):
            _metrics_close(metrics, m, 1e-4, f"{name} rank {r} step {s}")
        final, lr = _whole(want[name][-1][0][0], cfg), want[name][-1][2]["lr"]
        for (k, x), a in zip(params.items(), places["params"] if places else [None] * len(params),
                             strict=True):
            assert float((x - (final[k] if a is None else _cut(final[k], a, x))).abs().max()) <= lr



def test_a_supervised_restart_under_a_mesh_is_bit_equal(runs):
    """``TrainSupervisor`` at (2, 2) under ZeRO-1 with compression: every
    rank fails at step 3 and restores step 2's checkpoint; the run ends with
    the uninterrupted run's losses and every shard of its parameters,
    optimizer state and error tree, bit for bit."""
    for out in runs[1]:
        (r0, l0, s0), (r1, l1, s1) = out["supervised"]
        assert (r0, r1) == (0, 1) and l1 == l0[:3] + l0[2:]
        assert all(torch.equal(a, b) for a, b in zip([*s0[0].values(), *s0[1]], [*s1[0].values(), *s1[1]],
                                                  strict=True))


@pytest.mark.parametrize("arch, n_layers", [("qwen3-1.7b", 32), ("jamba-1.5-large-398b", 64)])
def test_compression_decides_by_the_reference_stacks(arch, n_layers):
    """The reduced model at a depth where a layer's leaf (a norm, jamba's
    router) is under ``MIN_SIZE`` but its stack (scan_block apart) is not:
    two error-feedback steps of ``compress_decompress`` with the model's
    plan, bit-equal to the reference's compressor on the stacked leaves,
    and ``wire_bytes`` equal; such leaves are compressed."""
    jcfg = dataclasses.replace(jax_reduced(arch), n_layers=n_layers)
    cfg = dataclasses.replace(reduced_config(arch), n_layers=n_layers)
    shapes = jax_sharding.unzip_params(jax.eval_shape(build_model(jcfg).init,
                                                      jax.random.PRNGKey(0)))[0]
    rng, mine, theirs = np.random.default_rng(11), GradientCompressor(), JaxCompressor()
    for step in range(2):
        g = jax.tree.map(lambda s: (rng.normal(size=s.shape) * rng.exponential(
            size=s.shape[:-1] + (1,))).astype(np.float32), shapes)
        tg = from_jax_tree(g, cfg)
        if not step:
            plan = compression_plan(tg, cfg.scan_block)
            err, jerr = mine.init_error(tg), theirs.init_error(g)
        want, jerr = theirs.compress_decompress(g, jerr)
        got, err = mine.compress_decompress(tg, err, plan)
        for t, w in ((got, want), (err, jerr)):
            assert all(torch.equal(a, b) for (_, a), b in zip(
                tree_items(t), _whole(w, cfg).values(), strict=True))
    assert mine.wire_bytes(got, plan) == theirs.wire_bytes(want)
    assert any(p is not None and x.numel() < 4096 for p, (_, x) in zip(plan, tree_items(tg)))
