"""The port's training path against the JAX package's, on 2 layers of the
reduced qwen3-1.7b: the same weights (through the weight bridge), the same
numpy tokens.  float32 unless a case says bfloat16: the loss within 1e-5
relative, gradients within 1e-4 x each leaf's max |g|, attention's gradient
within 2e-5 (summation order differs); bfloat16 within 2e-2 (the frameworks
round at different places).  Remat changes no number: the port's three
policies give equal results."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _one_torch_thread  # noqa: F401
from test_torch_model import model_pair

import repro.configs
import repro.kernels.ops as jax_ops
import repro.training.optimizer as jopt
from repro.data.workloads import TokenStream as JaxTokenStream
from repro.launch.train import main as jax_train
from repro.training.checkpoint import CheckpointManager as JaxCheckpoints
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch import configs
from repro_torch.data.workloads import TokenStream
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
from repro_torch.launch.train import main as train
from repro_torch.models.model import Model
from repro_torch.params import from_jax_tree, from_reference_state, tree_items, tree_map
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.train_loop import make_train_step

OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=30)


def _as_port(tree, cfg):
    """A JAX tree (parameters or gradients) in the port's layout, by path."""
    return dict(tree_items(from_jax_tree(jax.tree.map(np.asarray, tree), cfg)))


def _close_leaves(got, want, tol, what, rel=True):
    """Every leaf within ``tol`` (x its max |want| if ``rel``); a failure
    names the leaf."""
    for path, w in want.items():
        err = float((got[path].float() - w.float()).abs().max())
        assert err <= tol * (float(w.abs().max()) if rel else 1), f"{what}: {path} off by {err:.3g}"


def _loss_grads(cfg, params, batch):
    """(loss, metrics, each parameter's gradient by path) of a batch of numpy arrays."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    items = tree_items(live)
    loss, metrics = Model(cfg, "cpu").loss_fn(live, tree_map(torch.from_numpy, batch))
    grads = torch.autograd.grad(loss, [t for _, t in items])
    return float(loss.detach()), metrics, dict(zip([k for k, _ in items], grads, strict=True))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax_under_every_remat_policy(dt):
    _, jcfg, jm, jp, tm, tp = model_pair("qwen3-1.7b", dt)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(tokens)})
    runs = [_loss_grads(dataclasses.replace(tm.cfg, remat_policy=r), tp, {"tokens": tokens})
            for r in ("none", "minimal", "full")]
    for loss, metrics, grads in runs:
        assert loss == runs[0][0] and set(metrics) == set(jmet) == {"ce", "ppl_log", "loss"}
        assert all(torch.equal(g, runs[0][2][k]) for k, g in grads.items())
    tol = 1e-5 if dt == "float32" else 2e-2
    assert abs(runs[0][0] - float(jl)) <= tol * abs(float(jl))
    if dt == "float32":
        _close_leaves(runs[0][2], _as_port(jg, tm.cfg), 1e-4, "gradient")


# (B, S, H, K, D, window): G = 1 and 2, a window, lengths that are not a
# multiple of the kernels' 64-row tile, and the training head_dim 128 (the
# plain version's autograd is what the card holds K2's backward to)
@pytest.mark.parametrize("case", [(2, 40, 2, 2, 32, None), (2, 70, 4, 2, 32, None),
                                  (1, 100, 4, 2, 64, 24), (2, 130, 4, 1, 32, 50),
                                  (1, 130, 4, 2, 128, None)])
def test_attention_gradient_matches_jax(case):
    B, S, H, K, D, window = case
    rng = np.random.default_rng(S)
    arrays = [rng.normal(size=(B, S, n, D)).astype(np.float32) for n in (H, K, K, H)]
    want = jax.grad(lambda *qkv: (jax_ops.flash_attention(*qkv, window=window)
                                  * arrays[3]).sum(), argnums=(0, 1, 2))(*arrays[:3])
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:3]]
    got = torch.autograd.grad(ops.flash_attention(*leaves, window=window), leaves,
                              torch.from_numpy(arrays[3]))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)


def _jax_steps(jm, jp, batches, state=None):
    """The reference's train step over ``batches`` from ``state`` (default: a
    new AdamW state); returns (params, state, metrics of each step)."""
    init, step = jax_train_step(jm, jopt.OptConfig(**OPT))
    state, step, out = state or init(jp), jax.jit(step), []
    for tokens in batches:
        jp, state, metrics = step(jp, state, {"tokens": jnp.asarray(tokens)})
        out.append(metrics)
    return jp, state, out


def test_five_training_steps_match_jax():
    _, jcfg, jm, jp, tm, tp = model_pair("qwen3-1.7b", "float32")
    stream = JaxTokenStream(jcfg.vocab_size, 32, 8, seed=0)
    jp, _, jmet = _jax_steps(jm, jp, [next(stream) for _ in range(5)])
    init, step = make_train_step(tm, opt.OptConfig(**OPT))
    state, stream = init(tp), TokenStream(jcfg.vocab_size, 32, 8, seed=0)
    for want in jmet:
        tp, state, metrics = step(tp, state, {"tokens": torch.from_numpy(next(stream))})
        # the norm within the loss's 1e-5: an embedding gradient of -1.0e-8 here
        # against -7.7e-9 in JAX (4e-8 x the leaf's max |g|) moves its first
        # AdamW update by 4% (eps 1e-8), and step 5's norm by 1.9e-6 relative
        for name, tol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(metrics[name]), float(want[name]), rtol=tol)
    assert int(state.step) == 5
    _close_leaves(dict(tree_items(tp)), _as_port(jp, tm.cfg), 1e-4, "after 5 steps", rel=False)


def test_optimizer_pieces_match_jax():
    """lr_schedule over 32 steps, clip_by_global_norm below and above the
    norm, and one AdamW update, on seeded trees; adafloor is made by name
    (``tests/test_torch_hybrid.py`` holds it), an unknown name and gradient
    compression raise."""
    cfg, jcfg, rng = opt.OptConfig(**OPT), jopt.OptConfig(**OPT), np.random.default_rng(3)
    np.testing.assert_allclose([float(opt.lr_schedule(cfg, s)) for s in range(32)],
                               [float(jopt.lr_schedule(jcfg, jnp.asarray(s))) for s in range(32)],
                               rtol=1e-6)
    p, g, m, v = ({"a": rng.normal(size=(3, 5)).astype(np.float32),
                   "b": [np.abs(rng.normal(size=7)).astype(np.float32)]} for _ in range(4))
    t = tree_map(torch.tensor, [p, g, m, v])  # copies: the port steps the moments in place
    got = [*opt.clip_by_global_norm(t[1], 0.5), *opt.clip_by_global_norm(t[1], 100.0),
           *opt.adamw(cfg)[1](t[1], opt.AdamWState(torch.tensor(3, dtype=torch.int32), *t[2:]),
                              t[0])[:2]]
    want = [*jopt.clip_by_global_norm(g, 0.5), *jopt.clip_by_global_norm(g, 100.0),
            *jopt.adamw(jcfg)[1](g, jopt.AdamWState(jnp.int32(3), m, v), p)[:2]]
    for (_, a), (_, b) in zip(tree_items(got), tree_items(jax.tree.map(np.asarray, want)),
                              strict=True):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-9)
    assert opt.make_optimizer("adafloor")[0](p)[1]["b"][0].shape == (7,)
    with pytest.raises(ValueError, match="adafloor2"):
        opt.make_optimizer("adafloor2")
    with pytest.raises(NotImplementedError, match="M11"):
        make_train_step(Model(configs.reduced_config("qwen3-1.7b"), "cpu"), compression=object())


def test_token_stream_matches_jax_and_round_trips():
    mine, ref = TokenStream(1000, 16, 2, seed=3), JaxTokenStream(1000, 16, 2, seed=3)
    mine.step = ref.step = 4
    np.testing.assert_array_equal(next(mine), next(ref))
    again = TokenStream(1000, 16, 2, seed=3)
    again.load_state_dict(mine.state_dict())
    np.testing.assert_array_equal(next(again), next(mine))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_latest_and_gc(tmp_path, dt):
    ck = CheckpointManager(tmp_path, keep=2)
    tree = {"w": torch.randn(4, 3).to(dt), "layers": [{"b": torch.randn(5).to(dt)}]}
    state = opt.AdamWState(torch.tensor(7, dtype=torch.int32), tree, tree)
    for s in (2, 4, 6):
        ck.save(s, {"params": tree, "opt": state, "meta": {"s": s}})
    assert ck.steps() == [4, 6] and ck.latest_step() == 6
    assert not list(tmp_path.glob("*.tmp"))
    step, out = ck.restore({"params": tree, "opt": state, "meta": {}})
    assert step == 6 and out["meta"] == {"s": 6} and int(out["opt"].step) == 7
    for (_, a), (_, b) in zip(tree_items([out["params"], out["opt"]]),
                              tree_items([tree, state]), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _restores_from_reference(tmp_path, pair):
    """The reference's CheckpointManager writes the JAX parameters and
    optimizer state (the config's: AdamW's moments, adafloor's statistics)
    after one step; the port restores them through the bridge, and its next
    step's loss is the JAX step's."""
    _, jcfg, jm, jp, tm, _ = pair
    stream = JaxTokenStream(jcfg.vocab_size, 32, 8, seed=0)
    first, second = next(stream), next(stream)
    jp, jstate, _ = _jax_steps(jm, jp, [first])
    JaxCheckpoints(tmp_path).save(1, {"params": jp, "opt": jstate, "meta": {}})
    (want,) = _jax_steps(jm, jp, [second], jstate)[2]
    step, leaves, _ = CheckpointManager(tmp_path).read()
    params, (s, *moments) = from_reference_state(leaves, tm.cfg)
    assert step == 1 and int(s) == 1
    _close_leaves(dict(tree_items(moments[0])), _as_port(jstate[1], tm.cfg), 0, "moment")
    init, train_step = make_train_step(tm, opt.OptConfig(**OPT))
    _, _, metrics = train_step(params, type(init(params))(s, *moments),
                               {"tokens": torch.from_numpy(second)})
    assert abs(float(metrics["loss"]) - float(want["loss"])) <= 1e-5 * float(want["loss"])


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    _restores_from_reference(tmp_path, model_pair("qwen3-1.7b", "float32"))


def _cli_matches_reference(tmp_path, monkeypatch, arch, jcfg, tcfg, params):
    """``launch.train --arch arch --device cpu`` on the configs (jcfg, tcfg),
    the reference's weights ``params`` in both CLIs: ``--fail-at 6``
    restores step 4 and ends bit-equal to the uninterrupted run; the losses
    are the reference CLI's."""
    monkeypatch.setattr(repro.configs, "reduced_config", lambda name: jcfg)
    monkeypatch.setattr(configs, "reduced_config", lambda name: tcfg)
    monkeypatch.setattr(Model, "init", lambda self, seed: tree_map(torch.clone, params))
    argv = ["--arch", arch, "--steps", "10", "--ckpt-every", "4", "--device", "cpu"]
    want = jax_train([*argv[:6], "--ckpt-dir", str(tmp_path / "jax")])
    runs = [train([*argv, "--ckpt-dir", str(tmp_path / d), "--fail-at", f]) for d, f in
            (("a", "-1"), ("b", "6"))]
    assert runs[1]["report"].restarts == 1 and runs[1]["report"].restore_steps == [4]
    assert runs[0]["final_loss"] == runs[1]["final_loss"] and runs[0]["losses"] == runs[1]["losses"]
    assert sorted(runs[1]["losses"]) == sorted(want["losses"]) == list(range(10))
    for s, loss in want["losses"].items():
        assert abs(runs[1]["losses"][s] - loss) <= 1e-5 * loss, s


def test_train_cli_restart_is_exact_and_matches_the_reference(tmp_path, monkeypatch):
    """2 float32 layers, the reference's init in both CLIs."""
    _, jcfg, _, _, tm, tp = model_pair("qwen3-1.7b", "float32")
    _cli_matches_reference(tmp_path, monkeypatch, "qwen3-1.7b", jcfg, tm.cfg, tp)


# the K2 backward takes head_dim 64 and 128, q_offset 0, CUDA tensors only,
# and 8 queries over 5 keys only without a mask (causal or windowed, other
# lengths are a q_offset continuation)
@pytest.mark.parametrize("D, q_offset, match, Sk, mask", [
    (32, 0, "head_dim 32", 8, {}), (64, 3, "q_offset 3", 8, {}), (64, 0, "CUDA device", 8, {}),
    (64, 0, "Sq 8 != Sk 5", 5, {}), (64, 0, "Sq 8 != Sk 5", 5, {"causal": False, "window": 4})],
    ids=["32-0-head_dim 32", "64-3-q_offset 3", "64-0-CUDA device", "causal-Sk5", "window-Sk5"])
def test_k2_backward_refusals(D, q_offset, match, Sk, mask):
    q, k = torch.zeros(1, 8, 4, D), torch.zeros(1, Sk, 2, D)
    with pytest.raises(ValueError, match=match):
        flash_attention_bwd_cuda(q, k, k, q, q, torch.zeros(1, 4, 8), q_offset=q_offset, **mask)
    assert flash_attention_bwd_cuda.launches == 0
