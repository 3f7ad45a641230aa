"""The hybrid family (jamba-1.5-large-398b: Mamba2 and attention layers, MoE
on every second) and its optimizer, adafloor, against the JAX package.

Two float32 stacks, the same weights through the weight bridge, the same
numpy inputs: the reduced jamba (4 layers in 2 blocks of 2: ssm, attn+MoE)
and a 2-block interleave at jamba's own period (16 narrow layers, blocks of
8 with attention last).  Tolerances: logits 1e-4; the loss and router losses
1e-5 relative, gradients 1e-4 x each leaf's max |g|; five adafloor steps as
AdamW's (loss 1e-5, lr 1e-6, grad norm 1e-5, parameters 1e-4).  Adafloor
clips each update to an RMS over the reference's stacked leaf, a layer's
leaf with the same leaf of every other block: a control that clips layer by
layer misses the reference's parameters by far more than the tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _copy, _engines, _serve_both, fp32_pair
from test_torch_engine import _one_torch_thread  # noqa: F401
from test_torch_model import model_pair
from test_torch_train import (_check_five_steps, _check_loss_and_gradients, _cli_matches_reference,
                              _restores_from_reference)

import repro.configs
from repro_torch import configs
from repro_torch.core.engine import EngineConfig
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt

ARCH = "jamba-1.5-large-398b"
# the reduced config's 2 blocks of 2, and 2 blocks at jamba's period of 8
STACKS = {"reduced": {"n_layers": 4}, "interleave": {"n_layers": 16, "attn_period": 8,
                                                     "scan_block": 8}}


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_configs_and_reduced_configs_match_the_reference(arch):
    """Every config, and its reduced variant, field for field."""
    for mine, ref in ((configs.get_config, repro.configs.get_config),
                      (configs.reduced_config, repro.configs.reduced_config)):
        assert dataclasses.asdict(mine(arch)) == dataclasses.asdict(ref(arch))
    assert sorted(configs.ARCHS) == sorted(repro.configs.ARCHS)


@pytest.fixture(scope="module", params=list(STACKS))
def pair(request):
    return model_pair(ARCH, "float32", **STACKS[request.param])


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_forward_decode_and_rollback_match_jax(pair):
    """The forward; a 16-token prefill and a 4-token verify, each against the
    JAX model and the forward at its positions; the verify committed to 2
    and 4 tokens by row (both cache kinds roll back), then a step, against
    the JAX model's."""
    _, _, jm, jp, tm, tp = pair
    toks = np.random.default_rng(1).integers(0, 512, (2, 20)).astype(np.int32)
    full = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(full, jm.forward(jp, {"tokens": jnp.asarray(toks)}))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :16])}, max_len=64)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])}, 64)
    _close(tl, jl)
    _close(tl, full[:, 15])
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, 16:]))
    tl = tm.decode_step(tp, tc, torch.from_numpy(toks[:, 16:]))
    _close(tl, jl)
    _close(tl, full[:, 16:])
    accept = np.array([1, 3], np.int32)
    jc = jm.commit_cache(jc, jc["len"] - 4, jnp.asarray(accept))
    tm.commit_cache(tc, tc["len"] - 4, torch.from_numpy(accept))
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(toks[:, :1]))
    _close(tm.decode_step(tp, tc, torch.from_numpy(toks[:, :1])), jl)


@pytest.fixture(scope="module")
def fp32_jamba():
    return fp32_pair(ARCH, n_layers=4)


@pytest.mark.parametrize("trace", ["bursty", "uniform", "mixed_slo"])
def test_engine_matches_jax_engine(fp32_jamba, trace_factory, trace):
    """Exact-shape admissions (the stack is not attention-only), n-gram
    verify rolling back both cache kinds, 2 pairs: the same tokens, routing
    and RequestRecords as the JAX engine."""
    jreqs = trace_factory(trace, n=6)
    treqs = _copy(jreqs)
    jeng, teng = _engines(fp32_jamba, 2)
    assert [p.admit_cap() for p in teng.pairs] == [1, 1]
    if trace == "bursty":  # no prefill program: the verify buckets and the plain step
        assert teng.warmup() == jeng.warmup() == 2 * (len(EngineConfig().verify_buckets) + 1)
    _serve_both(jeng, teng, jreqs, treqs)


def test_loss_gradients_and_router_losses_match_jax_under_every_remat_policy(pair):
    _check_loss_and_gradients(pair)


@pytest.mark.parametrize("stack", list(STACKS))
def test_five_adafloor_steps_match_jax(stack, monkeypatch):
    """The config's optimizer (adafloor) and remat ("full"), 2 blocks, each
    stack's RMS clip binding; the leaves of 3 axes (the experts, wq) cut
    into slices of at most 1,000 elements."""
    monkeypatch.setattr(opt, "PIECE", 1000)
    pair = model_pair(ARCH, "float32", **STACKS[stack])
    assert (pair[1].optimizer, pair[1].remat_policy) == ("adafloor", "full")
    _check_five_steps(pair, 1e-4)


def test_adafloor_clipped_layer_by_layer_misses_the_reference():
    """The control: every layer its own stack (scan_block = n_layers)."""
    _, jcfg, jm, jp, tm, tp = model_pair(ARCH, "float32", **STACKS["reduced"])
    with pytest.raises(AssertionError, match="Not equal to tolerance|after 5 steps"):
        _check_five_steps((None, jcfg, jm, jp, Model(dataclasses.replace(
            tm.cfg, scan_block=4), "cpu"), tp), 1e-3)


def test_adafloor_state_restores_from_a_reference_checkpoint(tmp_path):
    _restores_from_reference(tmp_path, model_pair(ARCH, "float32", **STACKS["reduced"]))


def test_train_cli_restart_is_exact_and_matches_the_reference(tmp_path, monkeypatch):
    """``launch.train --arch jamba-1.5-large-398b``: the reduced config's
    adafloor and remat "full", 2 blocks; the restart restores adafloor's
    state."""
    _, jcfg, _, _, tm, tp = model_pair(ARCH, "float32", **STACKS["reduced"])
    _cli_matches_reference(tmp_path, monkeypatch, ARCH, jcfg, tm.cfg, tp)
