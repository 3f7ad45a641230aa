"""The port's model against the JAX model on the tiny qwen3 config: the same
weights (through the weight bridge) and the same tokens give the same logits
and the same cache positions.  Tolerances: 1e-4 in float32 (summation order
differs), 2e-2 in bfloat16 (the frameworks round at different places)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.distributed.sharding import unzip_params
from repro.models import build_model as jax_build
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.params import from_jax_tree

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MAX_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes need one intra-op thread; the suite's other workers get
    the rest of the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    dt = request.param
    jcfg = dataclasses.replace(jax_reduced("qwen3-1.7b"), n_layers=2, dtype=dt)
    tcfg = dataclasses.replace(reduced_config("qwen3-1.7b"), n_layers=2, dtype=dt)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = jax_build(jcfg)
    jparams, _ = unzip_params(jm.init(jax.random.PRNGKey(0)))
    tparams = from_jax_tree(jax.tree.map(np.asarray, jparams), tcfg)
    return dt, jm, jparams, build_model(tcfg, "cpu"), tparams


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


def _prefill(models):
    dt, jm, jp, tm, tp = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tm.cfg.vocab_size, (3, 32)).astype(np.int32)
    lengths = np.array([32, 17, 5], np.int32)  # bucketed: rows padded to 32
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens),
                             "lengths": jnp.asarray(lengths)}, max_len=MAX_LEN)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                             "lengths": torch.from_numpy(lengths)}, MAX_LEN)
    return (jl, jc), (tl, tc), rng


def _same_cache(tc, jc, dt):
    np.testing.assert_array_equal(tc["kv_pos"].numpy(), np.asarray(jc["blocks"]["0"]["kv_pos"]))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    if dt == "float32":  # bf16 K after rope can cancel to a few ulps apart
        _close(tc["k"], jc["blocks"]["0"]["k"], dt)
        _close(tc["v"], jc["blocks"]["0"]["v"], dt)


def test_prefill_bucketed_logits_and_cache(models):
    dt = models[0]
    (jl, jc), (tl, tc), _ = _prefill(models)
    _close(tl, jl, dt)
    _same_cache(tc, jc, dt)


def test_decode_t1_then_verify_t5_and_commit_rewind(models):
    dt, jm, jp, tm, tp = models
    (_, jc), (_, tc), rng = _prefill(models)
    for T, accept in ((1, None), (5, np.array([0, 2, 4], np.int32)), (1, None)):
        toks = rng.integers(0, tm.cfg.vocab_size, (3, T)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks))
        tl = tm.decode_step(tp, tc, torch.from_numpy(toks))
        _close(tl, jl, dt)
        _same_cache(tc, jc, dt)
        if accept is not None:  # rewind: stale verify slots must stay masked
            jc = jm.commit_cache(jc, jc["len"] - T, jnp.asarray(accept))
            tm.commit_cache(tc, tc["len"] - T, torch.from_numpy(accept))
            np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
