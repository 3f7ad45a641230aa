"""The port's model against the JAX model on the tiny configs of every dense
architecture it serves, and on hand-made configs whose query heads the
reference pads: the same weights (through the weight bridge, QKV biases set
nonzero) and the same tokens give the same logits and the same cache
positions.  Tolerances: 1e-4 in float32 (summation order differs), 2e-2 in
bfloat16 (the frameworks round at different places)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _one_torch_thread, nonzero_biases  # noqa: F401
from test_torch_kernels import _close as _close_at

from repro.configs import reduced_config as jax_reduced
from repro.distributed.sharding import unzip_params
from repro.models import build_model as jax_build
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.params import from_jax_tree

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MAX_LEN = 64


def model_pair(arch, dt, tree=None, **fields):
    """(dt, jcfg, JAX model, its params, the port's model, its params): the
    reduced ``arch``, 2 layers in dtype dt (and any other ``fields``), the
    same weights in both: the reference's init with nonzero QKV biases, or
    ``tree(jcfg, numpy params)``'s change of them."""
    fields = {"n_layers": 2, "dtype": dt, **fields}
    jcfg = dataclasses.replace(jax_reduced(arch), **fields)
    tcfg = dataclasses.replace(reduced_config(arch), **fields)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm = jax_build(jcfg)
    jparams, _ = unzip_params(jm.init(jax.random.PRNGKey(0)))
    npt = nonzero_biases(jax.tree.map(np.asarray, jparams))
    if tree is not None:
        npt = tree(jcfg, npt)
    tparams = from_jax_tree(npt, tcfg, dtype=getattr(torch, dt))
    return dt, jcfg, jm, jax.tree.map(jnp.asarray, npt), build_model(tcfg, "cpu"), tparams


# query heads the reference pads for its 16-way model axis, which the port
# drops: G 5 -> 8 and 9 -> 16 (reduced_config never pads)
PADDED = {"pad-g5": {"n_heads": 20, "n_kv_heads": 4}, "pad-g9": {"n_heads": 18, "n_kv_heads": 2}}
# qwen3 (GQA, tied embeddings) and llama2 (MHA: one query head a KV head,
# an untied head), qwen2.5 (QKV bias), starcoder2 (GELU MLP) and h2o-danube
# (a sliding window), each in both dtypes; the padded configs (with qwen2.5's
# bias) in float32
MODEL_CASES = {"float32": ("qwen3-1.7b", "float32"), "bfloat16": ("qwen3-1.7b", "bfloat16")}
MODEL_CASES.update({f"{a}-{dt}": (a, dt) for a in ("llama2-7b", "qwen2.5-14b", "starcoder2-7b",
                                                    "h2o-danube-3-4b")
                    for dt in ("float32", "bfloat16")})
MODEL_CASES.update({p: ("qwen2.5-14b", "float32", PADDED[p]) for p in PADDED})


@pytest.fixture(scope="module", params=list(MODEL_CASES.values()), ids=list(MODEL_CASES))
def models(request):
    arch, dt, *fields = request.param
    dt, _, *rest = model_pair(arch, dt, **(fields[0] if fields else {}))
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


def _pad_slots(cfg, a, axis):
    """``a`` with its pad query-head slots (``axis``) set to random values."""
    slot = np.arange(cfg.padded_heads) % cfg.padded_group >= cfg.n_heads // cfg.n_kv_heads
    a = a.copy()
    idx = (slice(None),) * axis + (slot,)
    a[idx] = np.random.default_rng(9).normal(size=a[idx].shape).astype(a.dtype)
    return a


def _noisy_pads(cfg, tree):
    attn = tree["blocks"]["0"]["attn"]  # leaves carry the layer axis first
    for name, axis in (("wq", 2), ("bq", 1), ("wo", 1)):
        attn[name] = _pad_slots(cfg, attn[name], axis)
    return tree


@pytest.mark.parametrize("pad", list(PADDED))
def test_reference_pad_slots_change_nothing(pad):
    """The reference masks its pad heads before ``wo``: random pad-slot
    ``wq``, ``bq`` and ``wo`` leave its logits as they were, and the port,
    which drops those slots, holds its H real heads either way."""
    dt, jcfg, jm, jp, tm, tp = model_pair("qwen2.5-14b", "float32", **PADDED[pad])
    *_, jnoisy, _, tnoisy = model_pair("qwen2.5-14b", "float32", tree=_noisy_pads,
                                       **PADDED[pad])
    assert jcfg.padded_heads == 32 and jp["blocks"]["0"]["attn"]["wq"].shape[2] == 32
    assert tp["layers"][0]["attn"]["wq"].shape[1] == jcfg.n_heads
    for name in ("wq", "bq", "wo"):
        assert not np.array_equal(jnoisy["blocks"]["0"]["attn"][name],
                                  jp["blocks"]["0"]["attn"][name])
        for layer, noisy in zip(tp["layers"], tnoisy["layers"], strict=True):
            torch.testing.assert_close(noisy["attn"][name], layer["attn"][name], atol=0, rtol=0)
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 24)),
                         jnp.int32)
    want, _ = jm.prefill(jp, {"tokens": tokens}, max_len=MAX_LEN)
    got, _ = jm.prefill(jnoisy, {"tokens": tokens}, max_len=MAX_LEN)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
