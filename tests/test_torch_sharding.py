"""M11 in one process: the port's sharding rules, parameter axes, health
tracking and refusals against the reference (the multi-rank paths are in
``test_torch_distributed.py``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharding.py
"""
import dataclasses
import random

import jax
import pytest
import torch
from test_torch_engine import _one_torch_thread  # noqa: F401

from repro import configs as jax_configs
from repro.distributed import fault_tolerance as jax_ft
from repro.distributed import sharding as jax_sharding
from repro.models import build_model as jax_build
from repro_torch import configs
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding
from repro_torch.models import moe
from repro_torch.models.model import build_model

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 4, "model": 8}, {"data": 4, "model": 4})
# tests/test_distributed.py:30-60, on its meshes (the first and the last) and the second
CASES = [(("embed", "heads", None), (4096, 32, 128)), (("embed", "heads", None), (5120, 40, 128)),
         (("kv", None), (8, 128)), (("heads", "mlp"), (32, 256)), (("batch", None), (256, 128))]


def _same_specs(leaves):
    """Every (axes, shape) under the four rules tables (equal to the
    reference's) and the three meshes: the reference's spec."""
    for name in ("DEFAULT_RULES", "POD_FSDP_RULES", "INFERENCE_RULES", "ZERO1_PARAM_RULES"):
        rules = getattr(sharding, name)
        assert rules == getattr(jax_sharding, name)
        for sizes in MESHES:
            mesh = type("Mesh", (), {"shape": sizes, "axis_names": tuple(sizes)})
            for axes, shape in leaves:
                want = tuple(jax_sharding.logical_to_spec(axes, mesh, rules, shape))
                assert sharding.logical_to_spec(axes, sizes, rules, shape) == want, (axes, shape)


def test_logical_to_spec_on_the_reference_cases():
    _same_specs(CASES)


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_specs_and_param_axes_match_the_reference(arch):
    """The specs of every parameter of the reference's init (traced, no
    weights made) at full and reduced size; then ``param_axes`` of the port's
    reduced init, leaf by leaf: layer i is the reference's block i %
    scan_block without its leading "layer"."""
    for cfg in (jax_configs.get_config(arch), jax_configs.reduced_config(arch)):
        tree = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0))
        _same_specs([(p.axes, p.value.shape) for p in
                     jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, jax_sharding.P))])
    want = jax_sharding.unzip_params(tree)[1]
    for stack, n in (("blocks", cfg.n_layers), ("encoder", cfg.n_encoder_layers)):
        if stack in want:
            blocks = jax.tree.map(lambda a: a[1:], want.pop(stack),
                                  is_leaf=lambda x: isinstance(x, tuple))
            want["layers" if stack == "blocks" else stack] = [blocks[str(i % cfg.scan_block)]
                                                              for i in range(n)]
    assert sharding.param_axes(build_model(configs.reduced_config(arch), "cpu").init(0)) == want


@pytest.mark.parametrize("seed", range(3))
def test_health_tracking_matches_the_reference(seed):
    """One seeded stream of heartbeats, sweeps and step times through both
    packages' HealthTracker and StragglerDetector: every sweep, the live set,
    the incarnations and the stragglers after every event alike."""
    rng = random.Random(seed)
    pairs = [(pkg.HealthTracker(4, dead_after=1.5), pkg.StragglerDetector(4, threshold=1.3))
             for pkg in (ft, jax_ft)]
    now, seen = 0.0, []
    for _ in range(200):
        now += rng.uniform(0.0, 0.8)
        wid, kind = rng.randrange(4), rng.choice(("heartbeat", "heartbeat", "sweep", "observe"))
        args = {"sweep": (now,), "observe": (wid, rng.choice((0.1, 0.12, 0.5)))}.get(kind,
                                                                                      (wid, now))
        seen.append([(getattr(s if kind == "observe" else h, kind)(*args), h.alive(),
                      [st.incarnation for st in h.state.values()], s.stragglers())
                     for h, s in pairs])
        assert seen[-1][0] == seen[-1][1]
    assert all(any(row[0][i] for row in seen) for i in range(4))  # deaths, rejoins, stragglers


@pytest.mark.parametrize("what", ["batch", "cache capacity", "experts", "training"])
def test_what_the_reference_leaves_to_gspmd_raises(what):
    """Where the reference falls back to GSPMD's layout (a cache capacity
    that does not split, experts that split neither way, in serving and in
    training), the port refuses by name.  A batch that does not split is
    held whole on every data shard, as the reference's spec holds it."""
    cfg = configs.reduced_config("mixtral-8x7b")
    model = build_model(cfg, "cpu")
    p, x = model.init(0)["layers"][0]["moe"], torch.zeros(2, 4, cfg.d_model)
    if what == "batch":
        with sharding.use_mesh({"data": 2, "model": 4}):
            assert model.init_cache(3, 32)["k"].shape[1:3] == (3, 8)
        return
    with sharding.use_mesh({"data": 2, "model": 4}), pytest.raises(
            ValueError, match="experts" if what == "training" else what):
        if what == "cache capacity":
            model.init_cache(4, 30)
        bad = dataclasses.replace(cfg, moe=configs.MoEConfig(6, 2, 6)) if what != "batch" else cfg
        moe.apply_moe(p, bad, x, losses=what == "training")


def test_moe_without_a_mesh_is_hierarchical_at_one_shard():
    """No mesh: apply_moe and apply_moe_hierarchical (one data shard) give
    the same bits, drops included."""
    cfg = configs.reduced_config("mixtral-8x7b")
    p = build_model(cfg, "cpu").init(0)["layers"][0]["moe"]
    x = torch.randn(4, 16, cfg.d_model, generator=torch.Generator().manual_seed(0)).to(
        p["wi"].dtype)
    assert torch.equal(moe.apply_moe(p, cfg, x), moe.apply_moe_hierarchical(p, cfg, x))
