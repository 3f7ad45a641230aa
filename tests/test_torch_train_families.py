"""Training of the Mamba2 and MoE families against the JAX package, on 2
layers of the reduced mamba2-2.7b and qwen3-moe-30b-a3b: the same weights
(through the weight bridge), the same numpy tokens, the MoE layers in the
reference's default dispatch without a mesh (``apply_moe``, as
``tests/test_torch_moe.py`` holds the forward).  float32 unless a case says
bfloat16: the loss and the router's two losses within 1e-5 relative, every
gradient leaf within 1e-4 x its max |g|, the metric keys the reference's;
bfloat16 within 2e-2.  Remat changes no number.  The SSD scan's gradient
alone is held to ``jax.grad`` through ``repro.kernels.ops.ssd_scan`` within
1e-4 x max |g|, and the MoE layer's, at a capacity that drops assignments,
to ``jax.grad`` through the reference's layer the same way.  The bf16 K4
backward's chunk-parallel schedule, walked in numpy, is held to jax.grad
within 2e-2 with the kernel's roundings and 1e-4 x max |g| without."""
import jax
import numpy as np
import pytest
import torch
from test_torch_engine import _one_torch_thread  # noqa: F401
from test_torch_model import model_pair
from test_torch_moe import _layer
from test_torch_paged import _bf16
from test_torch_train import _check_five_steps, _check_loss_and_gradients, _close_leaves

import repro.kernels.ops as jax_ops
from repro.models import moe as jax_moe
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
from repro_torch.models import moe

FAMILIES = ("mamba2-2.7b", "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_gradients_and_router_losses_match_jax(arch, dt):
    _check_loss_and_gradients(model_pair(arch, dt))


# the parameters after 5 steps, absolute: AdamW's first steps turn the two
# frameworks' differences in gradient entries near its eps into parameter
# differences of a share of lr (ROADMAP §3 item 9); in qwen3-moe a wk entry
# whose step-1 gradient was ~3e-8 moves 0.08 lr (1.2e-4) and an embedding
# entry with sqrt(nu) ~ eps 1.4e-4, where every entry with sqrt(nu) > 100 eps
# agrees within 1.1e-5
PARAM_TOL = {"mamba2-2.7b": 1e-4, "qwen3-moe-30b-a3b": 2e-4}


@pytest.mark.parametrize("arch", FAMILIES)
def test_five_training_steps_match_jax(arch):
    _check_five_steps(model_pair(arch, "float32"), PARAM_TOL[arch])


# (B, S, H, G, P, N, chunk): a ragged tail, 2 and 4 groups, chunks that do
# not divide S, one chunk past a single row
SSD_CASES = [(2, 37, 4, 1, 8, 16, 16), (1, 50, 4, 2, 8, 16, 32), (2, 24, 8, 4, 4, 8, 7),
             (1, 65, 8, 2, 16, 16, 64)]


def _grad_inputs(rng, B, S, H, G, P, N):
    """x, dt, A, B, C and dy (float32) as chip_smoke.py's ssd_case makes them:
    dt the softplus of a projection plus the init's bias, A -1 to -16."""
    bias = np.log(np.expm1(np.linspace(1e-3, 0.1, H)))
    arrays = [rng.normal(size=(B, S, H, P)) * 0.5, np.log1p(np.exp(rng.normal(size=(B, S, H))
                                                                   * 0.5 + bias)),
              -np.linspace(1.0, 16.0, H), rng.normal(size=(B, S, G, N)) * 0.5,
              rng.normal(size=(B, S, G, N)) * 0.5, rng.normal(size=(B, S, H, P))]
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_gradient_matches_jax(case):
    """Every input's gradient through the plain scan (what the card holds
    K4's backward to) against jax.grad through the reference's op, in
    float32 and, as the card's oracle, float64."""
    B, S, H, G, P, N, chunk = case
    *arrays, dy = _grad_inputs(np.random.default_rng(S), B, S, H, G, P, N)
    want = jax.grad(lambda *a: (jax_ops.ssd_scan(*a, chunk=chunk) * dy).sum(),
                    argnums=tuple(range(5)))(*arrays)
    for dtype in (torch.float32, torch.float64):
        leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
        got = torch.autograd.grad(ops.ssd_scan(*leaves, chunk=chunk)[0], leaves,
                                  torch.from_numpy(dy).to(dtype))
        for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want, strict=True):
            w = np.asarray(w)
            err = float(np.abs(g.double().numpy() - w).max())
            assert err <= 1e-4 * float(np.abs(w).max()), f"{dtype} {name} off by {err:.3g}"


def _bwd_walk(rnd, x, dt, A, Bm, C, dy, s0, spans=8, wrong=False):
    """ssd_bwd_wgmma_kernel's schedule in numpy (fp32): 64-row chunks cut into
    spans of ceil(nc / min(nc, spans)) (the kernel takes 8, fewer where the
    (row, head) pairs fill the card: 2 at mamba2-2.7b's training shape).
    Phase A: each span's U and V from zero (U = exp(cs_last) U + split(x o
    w)^T B, V += split(dy o exp(cs) Dpre)^T C), the state entering each chunk
    from a zero span state kept with log Dpre.
    The combine in fp32: S forward from the initial state, S = D S + U; G
    backward from zero, G = D G + V.  Phase B: each span's chunks in reverse,
    S = Dpre S_span + its slot, G stepping back, every gradient of the chunk
    from S, G and dB's and dC's masked scores as split (hi + lo) operands and
    dx's through rnd; <G, S> from the fp32 G (``wrong``: the chunk takes the
    G entering it, not the G leaving it).  rnd rounds to bf16 where the
    kernel does, or is the identity."""
    Bsz, S, H, P = x.shape
    rep, nc = H // Bm.shape[2], -(-S // 64)
    x, dt, Bm, C, dy = (np.pad(a, [(0, 0), (0, nc * 64 - S)] + [(0, 0)] * (a.ndim - 2))
                        .reshape(Bsz, nc, 64, *a.shape[2:]) for a in (x, dt, Bm, C, dy))
    Bm, C = (a.repeat(rep, 3) for a in (Bm, C))
    split = lambda a: rnd(a) + rnd(a - rnd(a))  # noqa: E731
    outer = lambda a, f, b: np.einsum("bjhp,bjhn->bhpn", split(a * f[..., None]), b)  # noqa: E731
    cs = np.cumsum(dt * A, axis=2)
    last = cs[:, :, -1]
    w, decay = np.exp(last[:, :, None] - cs) * dt, np.exp(last)[..., None, None]
    L = np.exp(np.where(np.tri(64, dtype=bool)[..., None], cs[:, :, :, None] - cs[:, :, None],
                        -np.inf))  # (B, nc, i, j, H)
    span = -(-nc // min(nc, spans))
    spans = [range(k, min(nc, k + span)) for k in range(0, nc, span)]
    ub, logs, parts = {}, {}, []
    for sp in spans:  # phase A
        u, v, logd = 0, 0, 0 * last[:, 0]
        for c in sp:
            ub[c], logs[c] = u, logd
            u = decay[:, c] * u + outer(x[:, c], w[:, c], Bm[:, c])
            v = v + outer(dy[:, c], np.exp(cs[:, c] + logd[:, None]), C[:, c])
            logd = logd + last[:, c]
        parts.append((u, v, np.exp(logd)[..., None, None]))
    s, s_in, g_out = s0, [], [None] * len(spans)
    g = 0 * s
    for u, _, d in parts:
        s_in.append(s)
        s = d * s + u
    for m in reversed(range(len(spans))):
        g_out[m], (_, v, d) = g, parts[m]
        g = d * g + v
    dx, dB, dC = (np.zeros((Bsz, nc, 64, H, k), np.float32) for k in (P, *Bm.shape[-1:] * 2))
    ddt, dA = np.zeros_like(dt), 0
    for m, sp in enumerate(spans):  # phase B
        g = g_out[m]
        for c in reversed(sp):
            st = np.exp(logs[c])[..., None, None] * s_in[m] + ub[c]  # the first: S_span
            g_in = decay[:, c] * g + outer(dy[:, c], np.exp(cs[:, c]), C[:, c])
            gu = g_in if wrong else g
            gc, ss = split(gu), split(st)
            xc, yc, bc, cc, tc, wc, ec = (a[:, c] for a in (x, dy, Bm, C, dt, w, np.exp(cs)))
            ys, d = np.einsum("bihp,bhpn->bihn", yc, ss), np.einsum("bihp,bjhp->bijh", yc, xc)
            k, dd = np.einsum("bihn,bjhn->bijh", cc, bc) * L[:, c], split(d * L[:, c] * tc[:, None])
            f = k * d
            xg = np.einsum("bjhp,bhpn->bjhn", xc, gc)
            u = np.einsum("bjhn,bjhn->bjh", bc, xg)
            dC[:, c] = ec[..., None] * ys + np.einsum("bijh,bjhn->bihn", dd, bc)
            dB[:, c] = wc[..., None] * xg + np.einsum("bijh,bihn->bjhn", dd, cc)
            dx[:, c] = wc[..., None] * np.einsum("bjhn,bhpn->bjhp", bc, gc) + np.einsum(
                "bijh,bihp->bjhp", rnd(k * tc[:, None]), yc)
            dcs = (np.einsum("bijh,bjh->bih", f, tc) - tc * f.sum(1) - wc * u
                   + ec * np.einsum("bihn,bihn->bih", cc, ys))
            dcs[:, -1] += (decay[:, c, :, 0, 0] * np.einsum("bhpn,bhpn->bh", gu, ss)
                           + (wc * u).sum(1))
            da = np.cumsum(dcs[:, ::-1], 1)[:, ::-1]
            ddt[:, c] = f.sum(1) + np.exp(last[:, c][:, None] - cs[:, c]) * u + A * da
            dA = dA + (tc * da).sum((0, 1))
            g = g_in
    unpad = lambda a: a.reshape(Bsz, nc * 64, *a.shape[3:])[:, :S]  # noqa: E731
    heads = lambda a: unpad(a).reshape(Bsz, S, -1, rep, a.shape[-1]).sum(3)  # noqa: E731
    return rnd(unpad(dx)), unpad(ddt), dA, rnd(heads(dB)), rnd(heads(dC))


# (B, S, H, G, spans) at P = 16, N = 32: one chunk and less, one chunk and one
# row (two blocks), 5 spans over a ragged tail in 2 groups, 8 spans of 4
# chunks and the training shape's 2 spans of 16
BWD_SCHEDULE_CASES = {"S5": (2, 5, 4, 2, 8), "S64": (1, 64, 4, 2, 8), "S65": (1, 65, 4, 2, 8),
                      "S300": (2, 300, 4, 2, 8), "S2048": (1, 2048, 2, 1, 8),
                      "S2048 2 spans": (1, 2048, 2, 1, 2)}


@pytest.mark.parametrize("case", BWD_SCHEDULE_CASES)
def test_ssd_backward_schedule_matches_jax(case):
    """The bf16 K4 backward's chunk-parallel schedule and two-way combine,
    walked in numpy on inputs as the card's check makes them (x, B, C and dy
    rounded to bf16, an initial state), against jax.grad through the
    reference's op: every gradient within 2e-2 + 2e-2 |g| with the kernel's
    bf16 roundings and hi + lo splits (ddt and dA as chip_smoke.py holds
    them), within 1e-4 x max |g| without.  A chunk that takes the G entering
    it, not the G leaving it, fails."""
    B, S, H, G, spans = BWD_SCHEDULE_CASES[case]
    rng = np.random.default_rng(S)
    arrays = [_bf16(a) if i in (0, 3, 4, 5) else a
              for i, a in enumerate(_grad_inputs(rng, B, S, H, G, 16, 32))]
    arrays.append((rng.normal(size=(B, H, 16, 32)) * 0.2).astype(np.float32))
    want = [np.asarray(g) for g in jax.grad(
        lambda *a: (jax_ops.ssd_scan(*a, chunk=64, initial_state=arrays[6]) * arrays[5]).sum(),
        argnums=tuple(range(5)))(*arrays[:5])]

    def check(rnd, atol, rtol, wrong=False):  # atol(w): the bound's absolute part
        got = _bwd_walk(rnd, *arrays, spans, wrong)
        for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want, strict=True):
            np.testing.assert_allclose(g, w, atol=atol(w), rtol=rtol, err_msg=name)

    bf16 = (_bf16, lambda w: 2e-2, 2e-2)
    check(*bf16)
    check(lambda a: a, lambda w: 1e-4 * np.abs(w).max(), 0)
    with pytest.raises(AssertionError):
        check(*bf16, wrong=True)


# (losses, capacity factor): serving's dispatch (dropped assignments to the
# spare row and slot 0) at 0.25, where most are dropped, and training's
# (each its own free slot) at 1.0, its least factor with drops
@pytest.mark.parametrize("losses, cf", [(False, 0.25), (True, 1.0)])
def test_moe_layer_gradient_matches_jax_and_dropped_assignments_get_none(monkeypatch, losses, cf):
    """With assignments dropped at capacity: the layer's gradients (input,
    router, experts) within 1e-4 x max |g| of the reference's, a dropped
    assignment's routing weight gets exactly zero gradient and a kept one's
    does not, and a token with every assignment dropped gets none."""
    jcfg, p, tcfg, tp = _layer("qwen3-moe-30b-a3b", "float32")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 32, jcfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda p, x: (jax_moe.apply_moe(p, jcfg, x, capacity_factor=cf)[0]
                                  * dy).sum(), argnums=(0, 1))(p, x)
    seen = {}

    def route(*args, **kw):  # keep the routing weights' gradient
        out = real_route(*args, **kw)
        out[0].retain_grad()
        seen["w"], seen["e"] = out[0], out[1]
        return out

    real_route = moe.route
    monkeypatch.setattr(moe, "route", route)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = moe.apply_moe(leaves, tcfg, tx, capacity_factor=cf, losses=losses)
    ((out[0] if losses else out) * torch.from_numpy(dy)).sum().backward()
    _close_leaves({**{k: t.grad for k, t in leaves.items()}, "x": tx.grad},
                  {**{k: torch.from_numpy(np.asarray(v)) for k, v in want[0].items()},
                   "x": torch.from_numpy(np.asarray(want[1]))}, 1e-4, "MoE gradient")
    flat_e = seen["e"].reshape(-1)
    order, _, _, keep = moe.sort_rank(flat_e, moe.capacity(64, tcfg, cf))
    kept = torch.empty_like(keep)
    kept[order] = keep
    gw = seen["w"].grad.reshape(-1)
    assert kept.any() and not kept.all()
    assert torch.all(gw[~kept] == 0) and torch.all(gw[kept] != 0)
    none_kept = ~kept.view(64, -1).any(1)
    assert none_kept.any() or losses
    assert torch.all(tx.grad.reshape(64, -1)[none_kept] == 0)


def test_k4_backward_refuses_cpu_tensors():
    x = torch.zeros(1, 8, 2, 16)
    Bm = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan_bwd_cuda(x, torch.zeros(1, 8, 2), torch.zeros(2), Bm, Bm, x)
    assert ssd_scan_bwd_cuda.launches == 0
