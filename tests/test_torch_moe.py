"""The port's mixture-of-experts layer, models and serves against the JAX
package, on the reduced qwen3-moe-30b-a3b and mixtral-8x7b.

The layer runs the same numpy inputs through ``repro.models.moe``'s
``apply_moe_global`` and ``apply_moe`` (no mesh) and through the port's
``apply_moe``: float32 within 2e-5 with identical routing and keep masks;
bfloat16 within 2e-2 on the tokens whose routing agrees, with at least 99%
of the assignments identical.  The models match in float32 within 1e-4, and
the fp32 engines give identical tokens and RequestRecords.  Capacity couples
the rows of a call (idle rows, bucket padding and verify padding take slots),
so every engine case runs on a tree whose router is skewed toward one expert
and asserts that assignments were dropped at capacity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import PAGED, _copy, _engines, _serve_both
from test_torch_engine import _one_torch_thread  # noqa: F401
from test_torch_model import _close, _prefill, _same_cache, model_pair

from repro.configs import MoEConfig as JaxMoEConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.distributed.sharding import unzip_params
from repro.models import build_model as jax_build
from repro.models import moe as jax_moe
from repro_torch.api import ServeConfig, StreamServe
from repro_torch.configs import MoEConfig, get_config, reduced_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import moe
from repro_torch.params import from_jax_tree, to_tensor

ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")


def _layer(arch, dt, **moe_fields):
    """(jcfg, numpy MoE params from the reference's init, tcfg, the port's
    params through the weight bridge, the router kept in fp32): the reduced
    ``arch`` in dtype dt, its MoEConfig changed by ``moe_fields``."""
    jcfg, tcfg = (dataclasses.replace(c, dtype=dt) for c in (jax_reduced(arch),
                                                             reduced_config(arch)))
    if moe_fields:
        fields = {**dataclasses.asdict(tcfg.moe), **moe_fields}
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **fields))
        tcfg = dataclasses.replace(tcfg, moe=MoEConfig(**fields))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    p, _ = unzip_params({"moe": jax_moe.init_moe(jax.random.PRNGKey(3), jcfg)})
    p = jax.tree.map(np.asarray, p["moe"])
    tree = {"embedding": {}, "blocks": {"0": {"moe": {k: v[None] for k, v in p.items()}}},
            "final_norm": np.ones(1, np.float32)}
    tp = from_jax_tree(tree, dataclasses.replace(tcfg, n_layers=1),
                       dtype=getattr(torch, dt))["layers"][0]["moe"]
    assert tp["router"].dtype == torch.float32 and tp["wi"].dtype == getattr(torch, dt)
    return jcfg, p, tcfg, tp


def _jit(fn, static=("capacity_factor",)):
    """A reference function (p, cfg, x, ...) compiled once a shape (op by op,
    each jnp call compiles on its own)."""
    return jax.jit(fn, static_argnums=1, static_argnames=static)


def _routing(route, sort_rank, p, cfg, x, C):
    """Each assignment's (expert, kept) in token order, through a package's
    router and sort-rank."""
    top_e = route(p, cfg, x)[1]
    flat_e = top_e.reshape(-1)
    order, _, _, keep = sort_rank(flat_e, C)
    kept = np.empty(len(flat_e), bool)
    kept[np.asarray(order)] = np.asarray(keep)
    return np.asarray(flat_e), kept


# (arch, MoEConfig changes, tokens (B, S), capacity factor): the reduced
# configs at a decode step (8 rows), a T = 5 verify and a 64-token prefill;
# 16 experts top-4 and a GELU expert FFN; capacity 0.25, where drops are certain
LAYER_CASES = {f"{a}-{B}x{S}": (a, {}, (B, S), 1.25) for a in ARCHS
               for B, S in ((8, 1), (8, 5), (2, 32))}
LAYER_CASES.update({"e16-top4-2x32": ("qwen3-moe-30b-a3b", {"n_experts": 16, "top_k": 4},
                                      (2, 32), 1.25),
                    "gelu-8x5": ("mixtral-8x7b", {}, (8, 5), 1.25),
                    "cf0.25-2x32": ("qwen3-moe-30b-a3b", {"n_experts": 8}, (2, 32), 0.25)})


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_reference(case, dt):
    arch, fields, shape, cf = LAYER_CASES[case]
    jcfg, p, tcfg, tp = _layer(arch, dt, **fields)
    if case.startswith("gelu"):
        jcfg, tcfg = (dataclasses.replace(c, mlp_type="gelu") for c in (jcfg, tcfg))
        p.pop("wg"), tp.pop("wg")
    rng = np.random.default_rng(sum(shape))
    jx = jnp.asarray(rng.normal(size=(*shape, jcfg.d_model)), jnp.dtype(dt))
    tx = to_tensor(np.asarray(jx))
    got = moe.apply_moe(tp, tcfg, tx, capacity_factor=cf)
    T = shape[0] * shape[1]
    C = moe.capacity(T, tcfg, cf)
    want_e, want_keep = _routing(_jit(jax_moe._router, ()), lambda e, C: jax_moe._sort_rank(
        e, len(e), C), p, jcfg, jx.reshape(T, -1), C)
    got_e, got_keep = _routing(moe.route, moe.sort_rank, tp, tcfg, tx.reshape(T, -1), C)
    same = (got_e == want_e) & (got_keep == want_keep)
    if cf < 1:
        assert not want_keep.all()  # capacity bound: assignments were dropped
    wants = [_jit(fn)(p, jcfg, jx, capacity_factor=cf)[0]
             for fn in (jax_moe.apply_moe_global, jax_moe.apply_moe)]
    if dt == "float32":
        assert same.all()
        for want in wants:
            _close(got, want, dt)
        return
    # bf16: a token whose two best experts round together may route apart
    assert same.mean() >= 0.99
    agree = same.reshape(T, -1).all(1).reshape(shape)
    for want in wants:
        _close(got[torch.from_numpy(agree)], np.asarray(want)[agree], dt)


@pytest.mark.parametrize("T, E, k, cf", [(1, 4, 2, 1.25), (5, 4, 2, 1.25), (8, 128, 8, 1.25),
                                         (40, 128, 8, 1.25), (64, 8, 2, 1.25),
                                         (512, 128, 8, 1.25), (96, 8, 2, 0.25),
                                         (33, 16, 4, 2.0)])
def test_capacity_and_sort_rank_match_reference(T, E, k, cf):
    jcfg = dataclasses.replace(jax_reduced(ARCHS[0]), moe=JaxMoEConfig(E, k, 256))
    tcfg = dataclasses.replace(reduced_config(ARCHS[0]), moe=MoEConfig(E, k, 256))
    C = moe.capacity(T, tcfg, cf)
    assert C == jax_moe._capacity(T, jcfg, cf)
    rng = np.random.default_rng(T)
    # skewed expert ids: ties within an expert exercise the stable sort
    flat_e = np.minimum(rng.geometric(0.3, T * k) - 1, E - 1).astype(np.int32)
    for got, want in zip(moe.sort_rank(torch.from_numpy(flat_e).long(), C),
                         jax_moe._sort_rank(jnp.asarray(flat_e), T * k, C), strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_prefill_decode_match_reference(arch):
    """Prefill logits and caches of a bucketed batch, then decode at T = 1 and
    T = 5 (fp32, 1e-4): ``tests/test_torch_model.py``'s checks on MoE."""
    models = model_pair(arch, "float32")
    dt, _, jm, jp, tm, tp = models
    (jl, jc), (tl, tc), rng = _prefill((dt, jm, jp, tm, tp))
    _close(tl, jl, dt)
    _same_cache(tc, jc, dt)
    assert "moe" in tp["layers"][0] and tp["layers"][0]["moe"]["router"].dtype == torch.float32
    for T in (1, 5):
        toks = rng.integers(0, tm.cfg.vocab_size, (3, T)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks))
        _close(tm.decode_step(tp, tc, torch.from_numpy(toks)), jl, dt)
        _same_cache(tc, jc, dt)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    for jcfg, tcfg in ((jax_get_config(arch), get_config(arch)),
                       (jax_reduced(arch), reduced_config(arch)),
                       *((dataclasses.replace(jax_get_config(arch), n_layers=n),
                          dataclasses.replace(get_config(arch), n_layers=n)) for n in (16,))):
        assert tcfg.n_params() == jcfg.n_params()
        assert tcfg.n_active_params() == jcfg.n_active_params()
    assert tcfg.n_active_params() < tcfg.n_params()


def _skewed(tree):
    """The reference's tree with each layer's router column 0 scaled by 4:
    the tokens that lean toward expert 0 all pick it, so it overflows."""
    for block in tree["blocks"].values():
        router = np.array(block["moe"]["router"])
        router[..., 0] *= 4.0
        block["moe"]["router"] = router
    return tree


@pytest.fixture
def drops(monkeypatch):
    """[assignments dropped at capacity, assignments] over the port's MoE calls."""
    seen = [0, 0]

    def counted(flat_e, C):
        out = sort_rank(flat_e, C)
        seen[0] += int((~out[3]).sum())
        seen[1] += len(flat_e)
        return out

    sort_rank = moe.sort_rank
    monkeypatch.setattr(moe, "sort_rank", counted)
    return seen


# case -> (arch, engine overrides, trace, prompt lengths): qwen3-moe dense
# (n-gram draft, SpecuStream verify buckets), paged and chunked; mixtral on
# its window-16 ring (48 slots), which prompts of 30-89 tokens wrap
MOE_ENGINE_CASES = {
    "qwen3-moe-dense": ("qwen3-moe-30b-a3b", {}, "mixed_slo", (6, 50)),
    "qwen3-moe-paged": ("qwen3-moe-30b-a3b", PAGED, "bursty", (6, 50)),
    "qwen3-moe-chunked": ("qwen3-moe-30b-a3b", {"prefill_chunk": 16}, "bursty", (6, 50)),
    "mixtral-ring": ("mixtral-8x7b", {}, "uniform", (30, 89)),
}


@pytest.mark.parametrize("case", list(MOE_ENGINE_CASES))
def test_moe_engine_matches_jax_engine(trace_factory, drops, case):
    arch, econf, trace, (lo, hi) = MOE_ENGINE_CASES[case]
    fields = {"n_layers": 2, "dtype": "float32"}
    jcfg = dataclasses.replace(jax_reduced(arch), **fields)
    tcfg = dataclasses.replace(reduced_config(arch), **fields)
    jparams, _ = unzip_params(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    tree = _skewed(jax.tree.map(np.asarray, jparams))
    pair = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg, from_jax_tree(tree, tcfg))
    jreqs = trace_factory(trace, n=6, lo=lo, hi=hi)
    treqs = _copy(jreqs)
    jeng, teng = _engines(pair, 2, **econf)
    _serve_both(jeng, teng, jreqs, treqs)
    assert len(teng.monitor.completed) == len(treqs)
    assert {r.worker_id for r in treqs} == {0, 1}
    assert drops[0] > 0  # capacity bound: some token lost an expert
    if tcfg.sliding_window:  # the ring wrapped
        assert max(len(r.prompt) for r in treqs) > teng.pairs[0].lane.cache["k"].shape[2]


def test_moe_entry_points_serve_on_cpu(capsys):
    """StreamServe on the reduced qwen3-moe and the serve CLI on the reduced
    mixtral complete their requests."""
    serve = StreamServe(ServeConfig(arch="qwen3-moe-30b-a3b", max_new_tokens=6), device="cpu")
    handles = [serve.submit(list(range(1, n))) for n in (9, 40, 17)]
    assert [len(h.result()) for h in handles] == [6, 6, 6]
    serve_cli.main(["--arch", "mixtral-8x7b", "--device", "cpu", "--requests", "4",
                    "--max-new", "6"])
    assert "completed 4/4" in capsys.readouterr().out

