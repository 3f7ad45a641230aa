"""The port's model against the JAX model on the tiny qwen3 and llama2
configs: the same weights (through the weight bridge) and the same tokens
give the same logits and the same cache positions.  Tolerances: 1e-4 in
float32 (summation order differs), 2e-2 in bfloat16 (the frameworks round at
different places)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _one_torch_thread  # noqa: F401
from test_torch_kernels import _close as _close_at

from repro.configs import reduced_config as jax_reduced
from repro.distributed.sharding import unzip_params
from repro.models import build_model as jax_build
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.params import from_jax_tree

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MAX_LEN = 64


def model_pair(arch, dt):
    """(dt, jcfg, JAX model, its params, the port's model, its params): the
    reduced ``arch``, 2 layers in dtype dt, the same weights in both."""
    jcfg = dataclasses.replace(jax_reduced(arch), n_layers=2, dtype=dt)
    tcfg = dataclasses.replace(reduced_config(arch), n_layers=2, dtype=dt)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = jax_build(jcfg)
    jparams, _ = unzip_params(jm.init(jax.random.PRNGKey(0)))
    tparams = from_jax_tree(jax.tree.map(np.asarray, jparams), tcfg, dtype=getattr(torch, dt))
    return dt, jcfg, jm, jparams, build_model(tcfg, "cpu"), tparams


# qwen3 (GQA, tied embeddings) and llama2 (MHA: one query head a KV head,
# an untied head), each in both dtypes
@pytest.fixture(scope="module", params=[("qwen3-1.7b", "float32"), ("qwen3-1.7b", "bfloat16"),
                                        ("llama2-7b", "float32"), ("llama2-7b", "bfloat16")],
                ids=["float32", "bfloat16", "llama2-7b-float32", "llama2-7b-bfloat16"])
def models(request):
    dt, _, *rest = model_pair(*request.param)
    return (dt, *rest)


_close = functools.partial(_close_at, tols=TOL)


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
