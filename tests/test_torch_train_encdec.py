"""Training of the encoder-decoder (seamless-m4t-large-v2) and the
vision-prefix model (internvl2-1b) against the JAX package, on their reduced
configs with 2 float32 layers (seamless also 2 encoder layers): the training
CLI, whose batches carry the reference's zero frames or patches, its restart
bit for bit; five AdamW steps on random frames and patches; and the cross
attention of the full-sequence path (K2 without a mask over Sq != Sk, whole
memory) with its gradient.  Tolerances: the loss 1e-5 relative, cross
attention and its gradient 1e-5, the parameters after 5 steps 1e-4
(tests/test_torch_train.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_encdec import ARCHS, _batch, _both
from test_torch_engine import _one_torch_thread  # noqa: F401
from test_torch_model import model_pair
from test_torch_train import OPT, _as_port, _cli_matches_reference, _close_leaves, _loss_grads

import repro.configs
import repro.training.optimizer as jopt
from repro.distributed.sharding import unzip_params
from repro.kernels import ref as jax_ref
from repro.models import build_model as jax_build
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch import configs
from repro_torch.models import attention as attn
from repro_torch.params import from_jax_tree, tree_items, tree_map
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import make_train_step


def _reference_pair(arch, **fields):
    """The reduced ``arch``, 2 float32 layers (and any other ``fields``), in
    both packages with the reference's init (QKV biases zero, as the CLI
    has them): (jcfg, the JAX model, its params, the port's config and
    params)."""
    fields = {"n_layers": 2, "dtype": "float32", **fields}
    jcfg = dataclasses.replace(repro.configs.reduced_config(arch), **fields)
    tcfg = dataclasses.replace(configs.reduced_config(arch), **fields)
    jm = jax_build(jcfg)
    jp = unzip_params(jm.init(jax.random.PRNGKey(0)))[0]
    return jcfg, jm, jp, tcfg, from_jax_tree(jax.tree.map(np.asarray, jp), tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_restart_is_exact_and_matches_the_reference(arch, tmp_path, monkeypatch):
    """``launch.train --device cpu`` with the reference's zero frames or
    patches: ``--fail-at 6`` restores step 4 (the parameter tree with the
    encoder, cross attention and untied head, or the QKV biases, and AdamW's
    moments) and ends bit-equal to the uninterrupted run; the losses are the
    reference CLI's (2 float32 layers, the reference's init in both)."""
    jcfg, _, _, tcfg, params = _reference_pair(arch)
    _cli_matches_reference(tmp_path, monkeypatch, arch, jcfg, tcfg, params)


# (Sq, Sk): target tokens over frames, fewer, more, and a ragged 64-row tile
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("Sq, Sk", [(5, 11), (64, 16), (100, 300)])
def test_cross_attention_and_its_gradient_match_jax(Sq, Sk, G):
    """``attention_cross`` without ``mem_pos`` (the whole memory, as
    ``forward`` and ``loss_fn`` pass it) through identity projections: the
    output and the gradients of x, K and V against the reference's
    ``ref.decode_attention(causal=False)`` at mem_len = Sk and its
    ``jax.grad``."""
    B, K, D = 2, 2, 32
    H = K * G
    rng = np.random.default_rng(Sq * Sk + G)
    q, k, v, dout = (rng.normal(size=(B, s, n, D)).astype(np.float32)
                     for s, n in ((Sq, H), (Sk, K), (Sk, K), (Sq, H)))

    def ref(q, k, v):
        return jax_ref.decode_attention(q, k, v, jnp.full((B,), Sk, jnp.int32), causal=False)

    want = ref(q, k, v)
    want_g = jax.grad(lambda *a: (ref(*a) * dout).sum(), argnums=(0, 1, 2))(q, k, v)
    eye = torch.eye(H * D)
    p = {"wq": eye.view(H * D, H, D), "wo": eye.view(H, D, H * D)}
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q.reshape(B, Sq, H * D), k, v)]
    out = attn.attention_cross(p, None, *leaves)
    got_g = torch.autograd.grad(out, leaves, torch.from_numpy(dout.reshape(B, Sq, H * D)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want).reshape(B, Sq, H * D),
                               atol=1e-5, rtol=1e-5)
    for g, w in zip(got_g, want_g, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_five_training_steps_match_jax(arch):
    """Five AdamW steps on batches of 8 x 24 tokens behind random frames
    (11 a row) or patches, so that the encoder's and cross attention's
    gradients are not zero: loss, grad norm and lr each step, then every
    parameter (the encoder's, the cross attention's) against the JAX
    package's."""
    _, jcfg, jm, jp, tm, tp = model_pair(arch, "float32")
    batches = [_both(_batch(jcfg, 8, 24, seed=s), "float32") for s in range(5)]
    jinit, jstep = jax_train_step(jm, jopt.OptConfig(**OPT))
    jstate, jstep = jinit(jp), jax.jit(jstep)
    init, step = make_train_step(tm, opt.OptConfig(**OPT))
    state = init(tp)
    for jb, tb in batches:
        jp, jstate, want = jstep(jp, jstate, jb)
        tp, state, metrics = step(tp, state, tb)
        for name, tol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(metrics[name]), float(want[name]), rtol=tol)
    assert int(state.step) == 5
    got, want = dict(tree_items(tp)), _as_port(jp, tm.cfg)
    assert any(k.startswith("encoder/") for k in got) == jcfg.is_encdec
    # internvl2's key bias: its exact gradient is 0 (a softmax ignores a shift
    # shared by all of a query's scores), so AdamW steps on rounding noise and
    # the two frameworks' bk part by up to 2.05e-4 of lr 3e-3 steps; every
    # other leaf within 8.9e-5
    noise = [k for k in want if k.endswith("attn/bk")]
    _close_leaves(got, {k: w for k, w in want.items() if k not in noise}, 1e-4, "after 5 steps",
                  rel=False)
    _close_leaves(got, {k: want[k] for k in noise}, 1e-3, "bk after 5 steps", rel=False)


@pytest.mark.parametrize("arch, depth", [("seamless-m4t-large-v2", {"n_encoder_layers": 24}),
                                         ("internvl2-1b", {"n_layers": 24})])
def test_zero_stub_inputs_overflow_the_gradient_at_depth_as_in_the_reference(arch, depth):
    """The CLI's zero frames or patches (the reference's ``make_batch``) send
    rows of zeros through the layers at init: RMSNorm's gradient there is w
    / sqrt(eps), 1000x a layer at eps 1e-6, so at the models' own depth of
    24 the gradient overflows and a weight's gradient (a zero activation
    times inf) is not finite, in the reference as in the port (the card's
    full-depth runs feed seeded random stub inputs instead: chip_smoke.py's
    train_probes)."""
    jcfg, jm, jp, tcfg, tp = _reference_pair(arch, **depth)
    n_front = 16 if jcfg.is_encdec else jcfg.frontend.n_tokens
    batch = {"tokens": np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32),
             "frames" if jcfg.is_encdec else "patches": np.zeros((2, n_front, jcfg.d_model),
                                                                 np.float32)}
    want = jax.grad(lambda p: jm.loss_fn(p, tree_map(jnp.asarray, batch))[0])(jp)
    got = _loss_grads(tcfg, tp, batch)[2]
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(want))
    assert not all(bool(torch.isfinite(g).all()) for g in got.values())
