"""Tensor-parallel serving across processes: four CPU ranks (gloo, one torch
thread each) on a (2, 2) data x model mesh run every case's model on their
shards (``shard_params`` under ``INFERENCE_RULES``): a prefill, a 5-token
verify and 8 greedy decode steps, each rank on its data shard's rows,
against the port without a mesh and the JAX model on the same weights (the
reference's init, nonzero QKV biases, through the weight bridge) and the
same numpy inputs.

Cases: the reduced configs of qwen3-1.7b, qwen2.5-14b (QKV bias),
h2o-danube-3-4b (a window), mamba2-2.7b, mixtral-8x7b, jamba (Mamba2,
attention and MoE), seamless-m4t-large-v2 and internvl2-1b, 2 layers each;
query heads the reference pads that split unevenly over "model" (18 heads
on one KV head: 16 and 2 a rank); and ``long_500k``'s layout, one row held
whole on both data shards.

    PYTHONPATH=src python -m pytest -q tests/test_torch_tensor_parallel.py
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import _one_torch_thread  # noqa: F401
from test_torch_model import model_pair

from repro_torch.configs import reduced_config

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-1.7b", "qwen2.5-14b", "h2o-danube-3-4b", "mamba2-2.7b", "mixtral-8x7b",
         "jamba-1.5-large-398b", "seamless-m4t-large-v2", "internvl2-1b")
CASES = {**{a: (a, {}, 4) for a in ARCHS},  # (arch, fields, rows)
         "padded uneven": ("qwen2.5-14b", {"n_heads": 18, "n_kv_heads": 1}, 4),
         "long_500k layout": ("h2o-danube-3-4b", {}, 1)}
MAX_LEN, S, STEPS = 64, 20, 8


def port_cfg(case):
    arch, fields, _ = CASES[case]
    return dataclasses.replace(reduced_config(arch), n_layers=2, dtype="float32", **fields)


def inputs(cfg, rows, seed=0):
    """Numpy tokens (rows, S) and verify tokens (rows, 5); 11 frames or the
    frontend's patches a row."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(rows, 11, cfg.d_model)).astype(np.float32)
    elif cfg.frontend is not None:
        batch["patches"] = rng.normal(size=(rows, cfg.frontend.n_tokens, cfg.d_model)).astype(
            np.float32)
    return batch, rng.integers(0, cfg.vocab_size, (rows, 5)).astype(np.int32)


def serve(prefill, decode, batch, verify, argmax):
    """Prefill, the verify, then greedy steps: every step's logits and the
    greedy tokens, as numpy."""
    out = {}
    out["prefill"], cache = prefill(batch)
    out["verify"], cache = decode(cache, verify)
    tok, greedy, toks = argmax(out["verify"][:, -1]), [], []
    for _ in range(STEPS):
        logits, cache = decode(cache, tok[:, None])
        tok = argmax(logits[:, 0])
        greedy.append(logits[:, 0])
        toks.append(tok)
    return {k: np.asarray(v) for k, v in dict(out, greedy=np.stack(greedy, 1),
                                               tokens=np.stack(toks, 1)).items()}


def serve_port(model, params, batch, verify):
    def decode(cache, tokens):
        return model.decode_step(params, cache, torch.as_tensor(np.asarray(tokens))), cache

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return serve(lambda b: model.prefill(params, tb, MAX_LEN), decode, batch, verify,
                 lambda x: np.asarray(x).argmax(-1).astype(np.int32))


def jitted(jm):
    """The JAX model's decode step and prefill (max_len static), compiled
    once a model."""
    return jax.jit(jm.decode_step), jax.jit(jm.prefill, static_argnums=2)


RANKS = textwrap.dedent("""
    # One of the four ranks: every case on its shards, under the mesh;
    # writes out<rank>.pkl, each case's results on its data shard's rows.
    import pickle, sys
    import numpy as np, torch
    import torch.distributed as dist
    from test_torch_tensor_parallel import CASES, port_cfg, serve_port
    from repro_torch.distributed import sharding
    from repro_torch.models import attention
    from repro_torch.models.model import Model
    from repro_torch.params import from_jax_tree

    rank, run = sys.argv[1:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{run}/rendezvous", rank=int(rank),
                            world_size=4)
    mesh = sharding.make_mesh((2, 2), device="cpu")
    i, j = mesh.get_coordinate()
    out = {}
    for case in CASES:
        cfg = port_cfg(case)
        tree, batch, verify = pickle.load(open(f"{run}/{case}.pkl", "rb"))
        params = from_jax_tree(tree, cfg)
        local = sharding.shard_params(params, sharding.param_axes(params), mesh,
                                      sharding.INFERENCE_RULES, cfg)
        rows = slice(2 * i, 2 * i + 2) if len(verify) % 2 == 0 else slice(None)
        with sharding.use_mesh(mesh):
            got = serve_port(Model(cfg, "cpu"), local, {k: v[rows] for k, v in batch.items()},
                             verify[rows])
        attn = [layer["attn"]["wq"].shape[1] for layer in local["layers"] if "attn" in layer]
        out[case] = (rows, got, attn[:1])
    # the straddling verify of ROADMAP §3 item 17: positions 14-16 of row 0
    # cross from rank 0's 16 slots into rank 1's; the write is the plain one
    g = torch.Generator().manual_seed(0)
    whole = {"k": torch.randn(2, 32, 2, 8, generator=g), "v": torch.randn(2, 32, 2, 8, generator=g),
             "kv_pos": torch.full((2, 32), -1, dtype=torch.int32)}
    new = torch.randn(2, 3, 2, 8, generator=g), torch.randn(2, 3, 2, 8, generator=g)
    clen = torch.tensor([14, 30])
    mine = {k: v[:, 16 * j:16 * (j + 1)].clone() for k, v in whole.items()}
    with sharding.use_mesh(mesh):
        attention._write_held(mine, *new, clen[:, None] + torch.arange(3))
    attention.write_cache(whole["k"], whole["v"], whole["kv_pos"], *new, clen)
    out["straddle"] = all(torch.equal(mine[k], whole[k][:, 16 * j:16 * (j + 1)]) for k in mine)
    pickle.dump(out, open(f"{run}/out{rank}.pkl", "wb"))
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (the JAX model's results, the port's without a mesh)}, and each
    rank's results."""
    run = tmp_path_factory.mktemp("tp")
    pairs = {}
    for case, (arch, fields, rows) in CASES.items():
        dt, jcfg, jm, jp, tm, tp = model_pair(arch, "float32", **fields)
        batch, verify = inputs(jcfg, rows)
        pickle.dump((jax.tree.map(np.asarray, jp), batch, verify), open(run / f"{case}.pkl", "wb"))
        pairs[case] = jm, jp, tm, tp, batch, verify
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    procs = [subprocess.Popen([sys.executable, "-c", RANKS, str(r), str(run)], env=env,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        want = {case: {} for case in pairs}
        for case, (jm, jp, tm, tp, batch, verify) in pairs.items():
            step, prefill = jitted(jm)
            for lo in range(0, len(verify), 2):  # each data shard's rows on their own
                b, v = {k: x[lo:lo + 2] for k, x in batch.items()}, verify[lo:lo + 2]
                jb = {k: jnp.asarray(x) for k, x in b.items()}
                want[case][lo] = (serve(lambda _, jb=jb: prefill(jp, jb, MAX_LEN),
                                        lambda c, t: step(jp, c, jnp.asarray(t)), b, v,
                                        lambda x: np.asarray(x).argmax(-1).astype(np.int32)),
                                  serve_port(tm, tp, b, v))
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs, strict=True):
        assert p.returncode == 0, err[-3000:]
    return want, [pickle.load(open(run / f"out{r}.pkl", "rb")) for r in range(4)]


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_serving_matches_the_port_and_jax(runs, case):
    """Each rank's prefill, verify and greedy logits against the port
    without a mesh and the JAX model on the same rows, fp32 within 1e-5, and
    the greedy tokens identical (a MoE layer's capacity comes from the rows
    of a call, under a mesh those of the rank's data shard, as in the
    reference: so the references run each data shard's rows on their own);
    the query heads each rank holds (16 and 2 for the uneven pad split,
    half of 4 otherwise)."""
    want, outs = runs
    for r, out in enumerate(outs):
        rows, got, heads = out[case]
        for ref in want[case][rows.start or 0]:
            for k in ("prefill", "verify", "greedy"):
                np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-5,
                                           err_msg=f"{case} rank {r} {k}")
            np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        assert heads == ([] if CASES[case][0] == "mamba2-2.7b" else
                         [(16, 2)[r % 2] if case == "padded uneven" else 2])


def test_the_straddling_write_is_the_plain_write(runs):
    assert all(out["straddle"] for out in runs[1])
