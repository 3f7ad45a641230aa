"""M11 across processes: the port's collectives, context-parallel decode and
expert-parallel MoE over real gloo process groups, against the reference's
shard_map runs on the same numpy inputs.

The module starts two things once, side by side: four CPU ranks of the port
(``RANKS``, one process each, a ``file://`` rendezvous in the module's
temporary directory) on a (2, 2) data x model, a (1, 4) data x model and a
(2, 2) pod x data ``DeviceMesh``; and one JAX subprocess with four host
devices that runs the reference on the same meshes.  Each rank keeps its
shard of every result with its place in the reference's global array, found
from its mesh coordinate (never its rank or a device id).  Both programs
are scripts run by ``python -c``, as ``tests/test_distributed_paths.py``
runs the reference's; they import this module's cases, so it imports no
JAX.

    PYTHONPATH=src python -m pytest -q tests/test_torch_distributed.py
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"m22": ((2, 2), ("data", "model")), "m14": ((1, 4), ("data", "model")),
          "pd": ((2, 2), ("pod", "data")), "d4": ((4,), ("data",))}
MOE = {"ep": ("m22", 1.25), "ep no drops": ("m22", 8.0), "split": ("m14", 1.25),
       "split no drops": ("m14", 8.0), "data only": ("d4", 1.25)}
CP = {"cp": ([10, 17], None), "cp window": ([10, 17], 8), "cp straddle": ([14, 30], None)}
PARAMS = {"wi": ("experts", "embed", "mlp"), "ck": ("batch", "kv_seq", "kv", None),
          "router": ("embed", None)}
CASES = [*MOE, "hierarchical", *CP, "har8", "har6", "ring", *(f"param {k}" for k in PARAMS)]


SHAPES = {"x": (4, 32, 128), "q": (2, 3, 4, 32), "kn": (2, 3, 2, 32), "vn": (2, 3, 2, 32),
          "ck": (2, 32, 2, 32), "cv": (2, 32, 2, 32), "xa": (2, 3, 128), "ring": (8, 3),
          "har8": (8, 16), "har6": (6, 16), "router": (128, 4), "wi": (4, 128, 256),
          "wg": (4, 128, 256), "wo": (4, 256, 128), "router2": (128, 2), "wi2": (2, 128, 64),
          "wg2": (2, 128, 64), "wo2": (2, 64, 128)}  # "2": the E = 2 layer


def _inputs():
    """Seeded numpy inputs, weights scaled by their fan-in.  x leans along u
    and every router's expert 0 with it, so capacity factor 1.25 drops
    assignments."""
    rng = np.random.default_rng(0)
    out = {k: rng.normal(size=shape) / (shape[-2] ** 0.5 if k[0] == "w" or "router" in k else 1)
           for k, shape in SHAPES.items()}
    u = rng.normal(size=128)
    out["x"] += u
    for k in ("router", "router2"):
        out[k][:, 0] += u / np.dot(u, u) * 3
    return {k: v.astype(np.float32) for k, v in out.items()}


def _moe_cfg(configs, split):
    """The reduced mixtral of either package's ``configs``; ``split``: E = 2
    < n_model = 4, so every rank takes f / 4 columns of each expert."""
    cfg = configs.reduced_config("mixtral-8x7b")
    moe = configs.MoEConfig(n_experts=2, top_k=1, d_ff_expert=64)
    return dataclasses.replace(cfg, moe=moe) if split else cfg


def _cp_cache(inp, clen):
    """The CP cases' whole cache: rows filled up to clen."""
    pos = np.broadcast_to(np.arange(32), (2, 32))
    return {"k": inp["ck"], "v": inp["cv"],
            "kv_pos": np.where(pos < np.asarray(clen)[:, None], pos, -1).astype(np.int32)}


RANKS = textwrap.dedent("""
    # One of the four ranks: every case on its shard; writes out<rank>.npz,
    # each result beside at/<key>, the (start, stop) of its leading
    # dimensions in the reference's global result.
    import dataclasses, sys
    import numpy as np, torch
    import torch.distributed as dist
    from test_torch_distributed import CP, MESHES, MOE, PARAMS, _cp_cache, _moe_cfg
    from repro_torch import configs
    from repro_torch.distributed import collectives, sharding
    from repro_torch.models import attention, moe

    rank, run_dir = sys.argv[1:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{run_dir}/rendezvous", rank=int(rank),
                            world_size=4)
    mesh = {k: sharding.make_mesh(*v, device="cpu") for k, v in MESHES.items()}
    raw = dict(np.load(f"{run_dir}/inputs.npz"))
    inp = {k: torch.from_numpy(v) for k, v in raw.items()}
    out = {}

    def put(key, value, *at):
        out[key], out["at/" + key] = np.asarray(value), np.array(at, dtype=int).reshape(-1, 2)

    for case, (m, cf) in MOE.items():
        cfg, tag = _moe_cfg(configs, m == "m14"), "2" * (m == "m14")
        p = {k: inp[k + tag] for k in ("router", "wi", "wg", "wo")}
        i, n = mesh[m].get_coordinate()[0], mesh[m].shape[0]
        rows = (4 * i // n, 4 * (i + 1) // n)
        x = inp["x"][slice(*rows)]
        local = sharding.shard_params(p, sharding.param_axes({"moe": p})["moe"], mesh[m],
                                      sharding.INFERENCE_RULES)
        with sharding.use_mesh(mesh[m]):
            put(case, moe.apply_moe(local, cfg, x, capacity_factor=cf), rows)
        _, top_e = moe.route(p, cfg, x.reshape(-1, 128))
        order, _, _, keep = moe.sort_rank(top_e.reshape(-1), moe.capacity(len(top_e), cfg, cf))
        put(case + "/keep", torch.empty_like(keep).index_put_((order,), keep).to(torch.int8),
            (i, i + 1))
    with sharding.use_mesh(mesh["m22"]):
        put("hierarchical", moe.apply_moe_hierarchical(
            {k: inp[k] for k in ("router", "wi", "wg", "wo")}, _moe_cfg(configs, False), inp["x"]))
    acfg = dataclasses.replace(configs.reduced_config("qwen3-1.7b"), n_heads=4, n_kv_heads=2,
                               head_dim=32, dtype="float32")
    attn_p = attention.init_attention(torch.Generator().manual_seed(0), acfg, torch.float32, "cpu")
    i, j = mesh["m22"].get_coordinate()
    for case, (clen, window) in CP.items():
        cfg = dataclasses.replace(acfg, sliding_window=window)
        cl, whole = torch.tensor(clen)[i:i + 1], _cp_cache(raw, clen)
        caches = [{k: torch.from_numpy(v[i:i + 1, 16 * j:16 * (j + 1)].copy())
                   for k, v in whole.items()} for _ in range(2)]
        with sharding.use_mesh(mesh["m22"]):
            put(case, attention._decode_attention_cp(
                mesh["m22"], cfg, *(inp[k][i:i + 1] for k in ("q", "kn", "vn")), caches[0], cl),
                (i, i + 1))
            layer = attention.attention_decode(attn_p, cfg, inp["xa"][i:i + 1], caches[1], cl)
        for k, v in caches[0].items():
            put(f"{case}/{k}", v, (i, i + 1), (16 * j, 16 * (j + 1)))
        plain = attention.attention_decode(attn_p, cfg, inp["xa"][i:i + 1], {
            k: torch.from_numpy(v[i:i + 1].copy()) for k, v in whole.items()}, cl)
        out["gap/" + case] = np.asarray((layer - plain).abs().max())
    pod, inner = mesh["pd"].get_coordinate()
    for n in (8, 6):
        at = (pod * n // 2, (pod + 1) * n // 2), (8 * inner, 8 * (inner + 1))
        y = inp[f"har{n}"][slice(*at[0]), slice(*at[1])]
        put(f"har{n}", collectives.make_hierarchical_psum(mesh["pd"])(y), *at)
    j4 = mesh["m14"].get_coordinate()[1]
    with sharding.use_mesh(mesh["m14"]):
        put("ring", collectives.ring_all_gather(inp["ring"][2 * j4:2 * j4 + 2], "model"),
            (8 * j4, 8 * j4 + 8))
    for k, axes in PARAMS.items():
        put("param " + k, sharding.shard_params(inp[k], axes, mesh["m22"]), (i, i + 1), (j, j + 1))
    np.savez(f"{run_dir}/out{rank}.npz", **out)
    dist.destroy_process_group()
""")


SCRIPT = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as PS
    import test_torch_distributed as t
    from repro import configs
    from repro.distributed.collectives import hierarchical_all_reduce, ring_all_gather
    from repro.distributed.sharding import DEFAULT_RULES, logical_to_spec
    from repro.kernels import ref as R
    from repro.models import attention as A, moe as M

    run = sys.argv[2]
    inp = dict(np.load(run + "/inputs.npz"))
    auto = (jax.sharding.AxisType.Auto,)  # the reference's layout hints need Auto axes
    meshes = {k: jax.make_mesh(shape, names, axis_types=auto * len(names))
              for k, (shape, names) in t.MESHES.items()}
    out = {}
    for case, (mk, cf) in t.MOE.items():
        split = mk == "m14"
        cfg, tag = t._moe_cfg(configs, split), "2" if split else ""
        p = {k: jnp.asarray(inp[k + tag]) for k in ("router", "wi", "wg", "wo")}
        with meshes[mk]:
            out[case] = jax.jit(lambda pp, xx: M.apply_moe_shardmap(
                pp, cfg, xx, capacity_factor=cf)[0])(p, jnp.asarray(inp["x"]))
        keeps = []
        for xs in np.split(inp["x"], meshes[mk].shape["data"]):  # each data shard's ranks
            TL = xs.shape[0] * xs.shape[1]
            _, top_e, _ = M._router(p, cfg, jnp.asarray(xs).reshape(TL, -1))
            C = M._capacity(TL, cfg, cf)
            order, _, _, keep = M._sort_rank(top_e.reshape(-1), TL * cfg.moe.top_k, C)
            keeps.append(np.asarray(keep)[np.argsort(np.asarray(order))])
        out[case + "/keep"] = np.stack(keeps).astype(np.int8)
        if case == "ep":
            with meshes[mk]:
                out["hierarchical"] = M.apply_moe_hierarchical(
                    p, cfg, jnp.asarray(inp["x"]), capacity_factor=cf)[0]
    acfg = dataclasses.replace(configs.reduced_config("qwen3-1.7b"), n_heads=4,
                               n_kv_heads=2, head_dim=32)
    mesh = meshes["m22"]
    for case, (clen, window) in t.CP.items():
        cfg = dataclasses.replace(acfg, sliding_window=window)
        cache, clen = t._cp_cache(inp, clen), jnp.asarray(clen, jnp.int32)
        with mesh:
            o, new = jax.jit(lambda *a: A._decode_attention_cp(mesh, cfg, *a))(
                inp["q"], inp["kn"], inp["vn"], cache, clen)
        shard_map = {"": o, **{"/" + k: v for k, v in new.items()}}
        ck, cv, cp = A.write_cache(*cache.values(), inp["kn"], inp["vn"], clen)
        plain = {"": R.decode_attention(inp["q"], ck, cv, clen + 3, kv_positions=cp,
                                        window=window), "/k": ck, "/v": cv, "/kv_pos": cp}
        # where a verify's tokens cross into the next rank's slots the
        # reference's shard_map loses a write: the port is held to its plain
        # write and attention there, and the shard_map's result kept apart
        held, other = (plain, shard_map) if case == "cp straddle" else (shard_map, plain)
        out.update({case + k: v for k, v in held.items()})
        out.update({case + k + " other": v for k, v in other.items()})
    for n in (8, 6):
        out[f"har{n}"] = jax.shard_map(
            lambda v: hierarchical_all_reduce(v, "pod", "data"), mesh=meshes["pd"],
            in_specs=PS("pod", "data"), out_specs=PS("pod", "data"),
            check_vma=False)(inp[f"har{n}"])
    out["ring"] = jax.shard_map(lambda v: ring_all_gather(v, "model"), mesh=meshes["m14"],
                                in_specs=PS("model"), out_specs=PS("model"),
                                check_vma=False)(inp["ring"])
    for k, axes in t.PARAMS.items():  # each device's piece, by mesh coordinate
        shape = inp[k].shape
        idx = NamedSharding(mesh, logical_to_spec(axes, mesh, DEFAULT_RULES, shape)
                            ).devices_indices_map(shape)
        out["param " + k] = np.stack([np.stack([inp[k][idx[d]] for d in row])
                                      for row in mesh.devices])
    np.savez(run + "/ref.npz", **{k: np.asarray(v) for k, v in out.items()})
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's global results, each rank's results)."""
    run_dir = tmp_path_factory.mktemp("m11")
    np.savez(run_dir / "inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, arg, str(run_dir)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for code, arg in [(SCRIPT, "-")] + [(RANKS, str(r)) for r in range(4)]]
    try:
        errs = [p.communicate(timeout=420)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs, strict=True):
        assert p.returncode == 0, err[-3000:]
    return (dict(np.load(run_dir / "ref.npz")),
            [dict(np.load(run_dir / f"out{r}.npz")) for r in range(4)])


@pytest.mark.parametrize("case", CASES)
def test_the_port_matches_the_reference(runs, case):
    """Each rank's shards of the case's results against the same place in
    the reference's, fp32 within 1e-5 (MoE keep masks and written cache
    positions exactly): expert-parallel MoE (its experts, or its columns of
    every expert when E < n_model, then one all-reduce) with drops at
    capacity factor 1.25, hierarchical MoE, context-parallel decode's output
    and written cache, both collectives, and shard_params' pieces against
    NamedSharding's ``devices_indices_map``."""
    ref, outs = runs
    for o in outs:
        for key in [k for k in o if k.split("/")[0] == case]:
            want = ref[key][tuple(slice(*b) for b in o["at/" + key])]
            np.testing.assert_allclose(o[key], want.reshape(o[key].shape), atol=1e-5, rtol=1e-5,
                                       err_msg=key)


def test_drops_layers_and_the_reference_faults(runs):
    """Capacity factor 1.25 drops assignments and 8.0 none; attention_decode
    under the mesh equals the layer on the whole cache; the reference's ring
    roll gives rank j of 4 at place q the shard (2 j - q) mod 4, and its CP write
    loses the token that crosses into the next rank's slots (ROADMAP §3)."""
    ref, outs = runs
    for case in MOE:
        assert ref[case + "/keep"].all() == case.endswith("no drops"), case
    assert max(o["gap/" + case] for o in outs for case in CP) < 1e-5
    shards = _inputs()["ring"].reshape(4, 2, 3)
    for j in range(4):
        want = shards[[(2 * j - q) % 4 for q in range(4)]].reshape(8, 3)
        assert np.array_equal(ref["ring"][8 * j:8 * j + 8], want)
    for case in CP:
        lost = not np.array_equal(ref[case + "/kv_pos"], ref[case + "/kv_pos other"])
        assert lost == (case == "cp straddle")
