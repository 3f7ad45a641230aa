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
from repro.distributed.compression import GradientCompressor as JaxCompressor
from repro.launch.train import main as jax_train
from repro.training.checkpoint import CheckpointManager as JaxCheckpoints
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch import configs
from repro_torch.data.workloads import TokenStream
from repro_torch.distributed.compression import MIN_SIZE, GradientCompressor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
from repro_torch.launch.train import main as train
from repro_torch.models.model import Model
from repro_torch.params import (from_jax_tree, from_reference_state, to_tensor, tree_items,
                                tree_map)
from repro_torch.training import optimizer as opt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.train_loop import make_train_step

OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=30)
ROUTER = ("load_balance", "router_z")  # a MoE model's router losses


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


def _check_loss_and_gradients(pair):
    """The loss, a MoE model's router losses and (float32) every gradient
    against the JAX model's, equal under the three remat policies."""
    dt, jcfg, jm, jp, tm, tp = pair
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(tokens)})
    runs = [_loss_grads(dataclasses.replace(tm.cfg, remat_policy=r), tp, {"tokens": tokens})
            for r in ("none", "minimal", "full")]
    keys = {"ce", "ppl_log", "loss", *(ROUTER if jcfg.moe else ())}
    for loss, metrics, grads in runs:
        assert loss == runs[0][0] and set(metrics) == set(jmet) == keys
        assert all(torch.equal(m, runs[0][1][k]) for k, m in metrics.items())
        assert all(torch.equal(g, runs[0][2][k]) for k, g in grads.items())
    tol = 1e-5 if dt == "float32" else 2e-2
    for name in ("loss", *(ROUTER if jcfg.moe else ())):
        want = float(jmet[name])
        assert abs(float(runs[0][1][name].detach()) - want) <= tol * abs(want), name
    if dt == "float32":
        _close_leaves(runs[0][2], _as_port(jg, tm.cfg), 1e-4, "gradient")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax_under_every_remat_policy(dt):
    _check_loss_and_gradients(model_pair("qwen3-1.7b", dt))


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


def _jax_steps(jm, jp, batches, state=None, compression=None):
    """The reference's train step over ``batches`` from ``state`` (default: a
    new AdamW state); returns (params, state, metrics of each step)."""
    init, step = jax_train_step(jm, jopt.OptConfig(**OPT), compression)
    state, step, out = state or init(jp), jax.jit(step), []
    for tokens in batches:
        jp, state, metrics = step(jp, state, {"tokens": jnp.asarray(tokens)})
        out.append(metrics)
    return jp, state, out


def _check_five_steps(pair, param_tol):
    """Five train steps of the config's optimizer against the JAX package's:
    the metrics (a MoE model's router losses too), then the parameters."""
    _, jcfg, jm, jp, tm, tp = pair
    stream = JaxTokenStream(jcfg.vocab_size, 32, 8, seed=0)
    jp, _, jmet = _jax_steps(jm, jp, [next(stream) for _ in range(5)])
    init, step = make_train_step(tm, opt.OptConfig(**OPT))
    state, stream = init(tp), TokenStream(jcfg.vocab_size, 32, 8, seed=0)
    names = (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6),
             *((k, 1e-5) for k in (ROUTER if jcfg.moe else ())))
    for want in jmet:
        tp, state, metrics = step(tp, state, {"tokens": torch.from_numpy(next(stream))})
        for name, tol in names:
            np.testing.assert_allclose(float(metrics[name]), float(want[name]), rtol=tol)
    assert int(state.step) == 5
    _close_leaves(dict(tree_items(tp)), _as_port(jp, tm.cfg), param_tol, "after 5 steps",
                  rel=False)


def test_five_training_steps_match_jax():
    # the norm within the loss's 1e-5: an embedding gradient of -1.0e-8 here
    # against -7.7e-9 in JAX (4e-8 x the leaf's max |g|) moves its first
    # AdamW update by 4% (eps 1e-8), and step 5's norm by 1.9e-6 relative
    _check_five_steps(model_pair("qwen3-1.7b", "float32"), 1e-4)


def test_five_compressed_training_steps_match_jax(capsys):
    """Five steps with int8 gradients and error feedback, the port's twice:
    held (each step from the reference's state: its parameters, AdamW
    moments and error tree through the bridge) and free (from its own).
    int8 rounding is a step function: the frameworks' gradients differ by
    ~1e-6 of a leaf's max, which moves a few entries across a rounding
    boundary, by one quantum (1/127 of the row's max |g + e|), in the
    gradient and in the error.  Where an entry's earlier gradients all
    rounded to 0, AdamW's update for it is then 0 on one side and up to lr
    on the other.  So, held, the loss, lr and grad norm hold step by step,
    and the parameters within 1e-4 and the error within 1e-6 everywhere but
    at those entries (at most 1e-3 of them a step), where the parameters
    stay within 2 lr and the error within one quantum of its row (plus
    1e-6).  Free, one step's flips move the next step's gradients, so the
    gaps grow: the loss holds within 1e-5 and lr within 1e-6, the grad norm
    within 1e-4 and the parameters within one lr; each free step's gaps
    are printed (``pytest -s``)."""
    _, jcfg, jm, jp, tm, tp = model_pair("qwen3-1.7b", "float32")
    jinit, jstep = jax_train_step(jm, jopt.OptConfig(**OPT), JaxCompressor())
    init, step = make_train_step(tm, opt.OptConfig(**OPT), GradientCompressor())
    jstate, jstep, free = jinit(jp), jax.jit(jstep), (tp, init(tp))
    jgrad = jax.jit(jax.grad(lambda p, b: jm.loss_fn(p, b)[0]))
    stream, off = JaxTokenStream(jcfg.vocab_size, 32, 8, seed=0), []
    for i in range(5):
        tokens = next(stream)
        (s, mu, nu), err = jstate
        quanta = _as_port(jax.tree.map(lambda g, e: jnp.broadcast_to(jnp.maximum(
            jnp.max(jnp.abs(g + e), -1, keepdims=True) / 127.0, 1e-12), g.shape) * (
            g.size >= MIN_SIZE), jgrad(jp, {"tokens": jnp.asarray(tokens)}), err), tm.cfg)
        tp, mu, nu, err = (from_jax_tree(jax.tree.map(np.asarray, t), tm.cfg)
                           for t in (jp, mu, nu, err))
        held = step(tp, (opt.AdamWState(torch.tensor(int(s), dtype=torch.int32), mu, nu), err),
                    {"tokens": torch.from_numpy(tokens)})
        free = step(*free[:2], {"tokens": torch.from_numpy(tokens)})
        jp, jstate, want = jstep(jp, jstate, {"tokens": jnp.asarray(tokens)})
        lr, theirs = float(want["lr"]), (_as_port(jp, tm.cfg), _as_port(jstate[1], tm.cfg))
        for params, (_, error), metrics in (held, free):
            rel = {k: abs(float(metrics[k]) - float(want[k])) / float(want[k])
                   for k in ("loss", "grad_norm", "lr")}
            assert rel["loss"] <= 1e-5 and rel["lr"] <= 1e-6, rel
            assert rel["grad_norm"] <= (1e-4 if metrics is free[2] else 1e-5), rel
            gaps = [[((t - w[path]).abs(), quanta[path]) for path, t in tree_items(got)]
                    for got, w in zip((params, error), theirs, strict=True)]
            worst, past = zip(*((max(float(d.max()) for d, _ in g), sum(
                int((d > tol).sum()) for d, _ in g)) for g, tol in zip(gaps, (1e-4, 1e-6))))
            if metrics is free[2]:
                assert worst[0] <= lr
                with capsys.disabled():
                    print(f"\nfree step {i + 1}: loss {rel['loss']:.3g}, grad_norm "
                          f"{rel['grad_norm']:.3g} relative; parameters max {worst[0]:.3g} "
                          f"({worst[0] / lr:.3f} lr), {past[0]} past 1e-4; error max "
                          f"{worst[1]:.3g}, {past[1]} past 1e-6")
                continue
            assert all(bool((d <= 2 * lr + 1e-4).all()) for d, _ in gaps[0])
            assert all(bool((d <= q + 1e-6).all()) for d, q in gaps[1])
            off += past
    assert max(off) <= 1e-3 * sum(d.numel() for d, _ in gaps[1]), off  # held, at each step


def test_compress_decompress_is_bit_equal_to_the_reference():
    """Four error-feedback steps over float32 and bfloat16 leaves with rows
    of very different scales and a row of zeros, and a leaf under
    ``MIN_SIZE``, which passes through; then ``wire_bytes``."""
    rng, mine, theirs = np.random.default_rng(7), GradientCompressor(), JaxCompressor()
    for step in range(4):
        g = [rng.normal(size=s) * rng.exponential(size=s[:-1] + (1,))
             for s in ((64, 96), (3, 40, 128), (10,), (80, 64))]
        g[1][1, 3] = 0.0
        jg = [jnp.asarray(a, jnp.bfloat16 if i == 3 else jnp.float32) for i, a in enumerate(g)]
        tg = [to_tensor(np.asarray(a)) for a in jg]
        if not step:
            err, jerr = mine.init_error(tg), theirs.init_error(jg)
        want, jerr = theirs.compress_decompress(jg, jerr)
        got, err = mine.compress_decompress(tg, err)  # in place
        assert all(torch.equal(a, to_tensor(np.asarray(b))) for a, b in
                   zip(got + err, want + jerr, strict=True))
    assert mine.wire_bytes(got) == theirs.wire_bytes(want)


def test_optimizer_pieces_match_jax():
    """lr_schedule over 32 steps, clip_by_global_norm below and above the
    norm, and one AdamW update, on seeded trees; adafloor is made by name
    (``tests/test_torch_hybrid.py`` holds it), an unknown name raises, and
    with gradient compression the optimizer state carries a zero float32
    error tree of the parameters' shapes."""
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
    state, err = make_train_step(Model(configs.reduced_config("qwen3-1.7b"), "cpu"),
                                 compression=GradientCompressor())[0](t[0])
    assert int(state.step) == 0 and all(torch.equal(e, p * 0) for (_, e), (_, p) in zip(
        tree_items(err), tree_items(t[0]), strict=True))


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


def _cli_matches_reference(tmp_path, monkeypatch, arch, jcfg, tcfg, params, extra=()):
    """``launch.train --arch arch --device cpu`` (and ``extra`` flags) on the
    configs (jcfg, tcfg), the reference's weights ``params`` in both CLIs:
    ``--fail-at 6`` restores step 4 and ends bit-equal to the uninterrupted
    run; the losses are the reference CLI's."""
    monkeypatch.setattr(repro.configs, "reduced_config", lambda name: jcfg)
    monkeypatch.setattr(configs, "reduced_config", lambda name: tcfg)
    monkeypatch.setattr(Model, "init", lambda self, seed: tree_map(torch.clone, params))
    argv = ["--arch", arch, "--steps", "10", "--ckpt-every", "4", *extra, "--device", "cpu"]
    want = jax_train([*argv[:-2], "--ckpt-dir", str(tmp_path / "jax")])
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


def test_compressed_train_cli_restart_is_exact_and_matches_the_reference(tmp_path, monkeypatch):
    """``--compress-grads``: the error tree is saved beside the optimizer
    state and restored with it, so the failed run replays bit for bit."""
    _, jcfg, _, _, tm, tp = model_pair("qwen3-1.7b", "float32")
    _cli_matches_reference(tmp_path, monkeypatch, "qwen3-1.7b", jcfg, tm.cfg, tp,
                           ["--compress-grads"])
    assert any("opt__1__" in f.name for f in (tmp_path / "b").rglob("*.npy"))


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


def test_reduced_heads_reach_the_training_kernels_on_zero_padded_copies(monkeypatch):
    """K2's backward takes head_dim 64 and 128, K4's bfloat16 kernels P = 64
    and N = 128: on the card a reduced model's heads (32; P 32, N 16) reach
    them padded with zeros (``FlashAttentionFn``'s backward, ``ssd.widened``);
    K2's forward takes head_dim 32 as it is.  With the plain versions as
    stand-ins for the kernels (refusing any other shape), the outputs and
    gradients equal the plain versions' on the unpadded tensors (float32
    within 1e-6, bfloat16 to its rounding)."""
    gen = torch.Generator().manual_seed(0)
    attn = [torch.randn(2, 40, h, 32, generator=gen) for h in (4, 2, 2)]
    scan = [torch.randn(2, 100, 4, 32, generator=gen).bfloat16(), torch.rand(2, 100, 4, generator=gen),
            -torch.rand(4, generator=gen) - .5,
            *(torch.randn(2, 100, 1, 16, generator=gen).bfloat16() for _ in "BC")]

    def k2(q, k, v, out=None, dout=None, lse=None, **mask):  # K2's forward or backward
        assert q.shape[-1] == (32 if dout is None else 64)
        if dout is None:
            return ref.flash_attention(q, k, v, **mask), None
        live = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            return torch.autograd.grad(ref.flash_attention(*live, **mask), live, dout)

    def k4(x, dt, A, Bm, C, s0=None, kernel=True):
        assert (x.shape[3], Bm.shape[3]) == ((64, 128) if kernel else (32, 16))
        return ref.ssd_scan(x, dt, A, Bm, C, chunk=64, initial_state=s0)

    monkeypatch.setattr(fa, "flash_attention_cuda", k2)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", k2)
    for run, plain, ins in (
            (lambda *t: fa.FlashAttentionFn.apply(*t, True, None, None), ref.flash_attention, attn),
            (lambda *t: ssd.widened(k4, *t)[0], lambda *t: k4(*t, kernel=False)[0], scan)):
        dout, outs = torch.randn(ins[0].shape, generator=gen).to(ins[0].dtype), []
        for f in (run, plain):
            live = [t.clone().requires_grad_() for t in ins]
            y = f(*live)
            outs.append([y.detach(), *torch.autograd.grad(y, live, dout)])
        for a, b in zip(*outs, strict=True):
            tol = 1e-2 if b.dtype == torch.bfloat16 else 1e-6
            assert a.shape == b.shape and a.dtype == b.dtype
            assert float((a - b).float().abs().max()) <= tol * float(b.float().abs().max())
