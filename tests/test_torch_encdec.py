"""The encoder-decoder (seamless-m4t-large-v2: an audio frontend stub feeding
its encoder) and the vision-prefix model (internvl2-1b: stub patches before
the text) against the JAX package, on their reduced configs with 2 layers
(seamless also 2 encoder layers): the same weights through the weight
bridge, the same numpy tokens, frames and patches.  Tolerances: logits 1e-4
in float32, 2e-2 in bfloat16; the loss 1e-5 relative and each gradient leaf
1e-4 x its max |g| (tests/test_torch_train.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _one_torch_thread  # noqa: F401
from test_torch_model import _close, model_pair
from test_torch_train import _as_port, _close_leaves, _loss_grads

from repro.configs import get_config as jax_config
from repro_torch.api import ServeConfig, StreamServe
from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig, PipeServeEngine
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.params import from_jax_tree, tree_items

ARCHS = ("seamless-m4t-large-v2", "internvl2-1b")
CASES = {f"{a}-{dt}": (a, dt) for a in ARCHS for dt in ("float32", "bfloat16")}
MAX_LEN = 64


@pytest.fixture(scope="module", params=list(CASES.values()), ids=list(CASES))
def pair(request):
    return model_pair(*request.param)


def _batch(cfg, B, S, seed=0):
    """Numpy inputs: tokens (B, S), and the frontend's 11 frames or its
    ``n_tokens`` patches a row."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(B, 11, cfg.d_model)).astype(np.float32)
    elif cfg.frontend is not None:
        batch["patches"] = rng.normal(size=(B, cfg.frontend.n_tokens, cfg.d_model)).astype(
            np.float32)
    return batch


def _both(batch, dt):
    """The batch as JAX arrays and as torch tensors: floats rounded to dt once,
    in JAX, so that both frameworks get the same values."""
    jb, tb = {}, {}
    for k, v in batch.items():
        jb[k] = jnp.asarray(v, dt if v.dtype == np.float32 else v.dtype)
        tb[k] = torch.from_numpy(np.array(jb[k].astype(jnp.float32)) if v.dtype == np.float32
                                 else v).to(getattr(torch, dt) if v.dtype == np.float32
                                            else torch.int32)
    return jb, tb


def test_forward_loss_and_gradients_match_jax(pair):
    dt, jcfg, jm, jp, tm, tp = pair
    batch = _batch(jcfg, 2, 12)
    jb, tb = _both(batch, dt)
    want = jm.forward(jp, jb)
    got = tm.forward(tp, tb)
    assert got.shape == (2, 12, jcfg.padded_vocab)  # the text's logits, not the prefix's
    _close(got, want, dt)
    if dt == "float32":
        (jl, _), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jb)
        loss, _, grads = _loss_grads(tm.cfg, tp, batch)
        assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
        want_g = _as_port(jg, tm.cfg)
        assert set(grads) == set(want_g)
        _close_leaves(grads, want_g, 1e-4, "gradient")


def test_prefill_verify_commit_and_greedy_tokens_match_jax(pair):
    """Prefill logits and cache (kv_pos, len; an encoder-decoder's cross K/V
    and mem_len; init_cache's layout), a 5-token verify, a commit at per-row accept indices, then
    8 greedy tokens, token for token in float32."""
    dt, jcfg, jm, jp, tm, tp = pair
    jb, tb = _both(_batch(jcfg, 2, 12, seed=1), dt)
    jl, jc = jm.prefill(jp, jb, max_len=MAX_LEN)
    tl, tc = tm.prefill(tp, tb, MAX_LEN)
    _close(tl, jl, dt)
    empty = tm.init_cache(2, MAX_LEN, cross_len=11)  # the layout prefill fills
    assert {k: t.shape for k, t in empty.items()} == {k: t.shape for k, t in tc.items()}

    def same_cache():
        np.testing.assert_array_equal(tc["kv_pos"].numpy(),
                                      np.asarray(jc["blocks"]["0"]["kv_pos"]))
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        if jcfg.is_encdec:
            np.testing.assert_array_equal(tc["mem_len"].numpy(), np.asarray(jc["mem_len"]))
            assert bool((tc["mem_pos"] >= 0).all()) and tc["mem_pos"].shape == (2, 11)
        names = ("k", "v") + (("cross_k", "cross_v") if jcfg.is_encdec else ())
        for name in names if dt == "float32" else ():  # bf16 K after rope: a few ulps apart
            _close(tc[name], jc["blocks"]["0"][name], dt)

    same_cache()
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks))
    tl = tm.decode_step(tp, tc, torch.from_numpy(toks))
    _close(tl, jl, dt)
    same_cache()
    accept = np.array([1, 4], np.int32)
    jc = jm.commit_cache(jc, jc["len"] - 5, jnp.asarray(accept))
    tm.commit_cache(tc, tc["len"] - 5, torch.from_numpy(accept))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    if dt != "float32":
        return
    jt = tt = np.asarray(jl)[[0, 1], accept].argmax(-1).astype(np.int32)
    jseq, tseq = [], []
    for _ in range(8):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(jt)[:, None])
        tl2 = tm.decode_step(tp, tc, torch.from_numpy(tt)[:, None])
        jt, tt = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32), tl2[:, 0].argmax(-1).numpy()
        jseq.append(jt.tolist())
        tseq.append(tt.astype(np.int32).tolist())
    assert tseq == jseq
    same_cache()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_forward(arch):
    """Prefill of 12 tokens, then a 4-token decode step, gives the logits of
    the full forward over all 16 (the cache correctness test of
    tests/test_models_smoke.py, on the port)."""
    *_, tm, tp = model_pair(arch, "float32")
    tb = _both(_batch(tm.cfg, 1, 16, seed=3), "float32")[1]
    full = tm.forward(tp, tb)
    _, cache = tm.prefill(tp, dict(tb, tokens=tb["tokens"][:, :12]), MAX_LEN)
    torch.testing.assert_close(tm.decode_step(tp, cache, tb["tokens"][:, 12:]), full[:, 12:],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_refusals(arch, monkeypatch):
    """Bucketed prefill, the engine (no request carries frames or patches)
    and, without CUDA, build_model's default device; on a CUDA-side tensor
    under autograd, K1 (it has no backward: the model's cross attention
    takes its gradient through K2, serving's prefill and decode run K1)."""
    *_, tm, tp = model_pair(arch, "float32")
    tb = _both(_batch(tm.cfg, 2, 8), "float32")[1]
    with pytest.raises(NotImplementedError, match="bucketed prefill"):
        tm.prefill(tp, dict(tb, lengths=torch.tensor([8, 5], dtype=torch.int32)), MAX_LEN)
    econf = EngineConfig(max_batch=2, max_len=MAX_LEN)
    for make in (lambda: PipeServeEngine(tm.cfg, tp, n_pairs=1, device="cpu", econf=econf),
                 lambda: StreamServe(ServeConfig.reduced_smoke(), arch_cfg=tm.cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="frames or patches"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tm.cfg)
    q = torch.zeros(2, 3, 4, 32, device="meta", requires_grad=True)  # off the CPU path
    k = torch.zeros(2, 11, 4, 32, device="meta")
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.decode_attention(q, k, k, torch.zeros(2, dtype=torch.int32, device="meta"),
                             causal=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_and_the_bridge_takes_every_leaf_once(arch):
    """``n_params`` equals the reference's at full and reduced size, and the
    bridge moves every element of the reference's tree (encoder, enc_norm,
    cross attention and norm_cross included) into the port's exactly once."""
    assert get_config(arch).n_params() == jax_config(arch).n_params()
    _, jcfg, _, jp, tm, tp = model_pair(arch, "float32")
    assert tm.cfg.n_params() == jcfg.n_params()
    count = iter(range(1, 1 << 24))
    tagged = jax.tree.map(lambda a: np.array([next(count) for _ in range(a.size)],
                                             np.float32).reshape(a.shape), jp)
    ported = from_jax_tree(tagged, tm.cfg)
    assert ("encoder" in ported) == ("cross" in ported["layers"][0]) == jcfg.is_encdec
    got = np.sort(np.concatenate([t.numpy().ravel() for _, t in tree_items(ported)]))
    assert got.size == sum(a.size for a in jax.tree.leaves(jp))
    np.testing.assert_array_equal(got, np.arange(1, got.size + 1, dtype=np.float32))
