"""The port's discrete-event simulator against the JAX package's, and the four
``examples/*_torch.py`` on the CPU.

Both simulators run the same deployment on the same seeded trace (request ids
set alike) and must give equal summaries, traces and per-request records,
float for float.  They price with the reference's TPU profile, rebuilt field
for field, so that both cost models see the same numbers; the port's own
default is ``H100_SXM``.  ``extend_sequence`` and ``to_sim_config`` are held
alone too.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
from test_torch_engine import _one_torch_thread  # noqa: F401

import repro.api as jax_api
import repro.serving.simulator as jax_sim
from repro.configs import get_config as jax_config
from repro.data import workloads as jax_workloads
from repro.serving.cost_model import TPU_V5E
from repro.serving.cost_model import CostModel as JaxCostModel
from repro.serving.kv_cache import KVCacheManager as JaxKV
from repro_torch.api import ServeConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import workloads
from repro_torch.serving import simulator
from repro_torch.serving.cost_model import H100_SXM, CostModel, HardwareProfile
from repro_torch.serving.kv_cache import KVCacheManager

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
TPU = HardwareProfile(**dataclasses.asdict(TPU_V5E))  # the reference's rates, for parity only


def _trace(pkg, mixed):
    reqs = (pkg.sample_mixed(10, seed=0, arrival_rate=40.0) if mixed else
            pkg.sample_requests("gsm8k", 60, seed=0, arrival_rate=10.0))
    for i, sim in enumerate(reqs):
        sim.request.request_id = f"r{i}"
    return reqs


def _run(sim_mod, cfg, preset, kw, fail, pkg, **hw):
    sim = sim_mod.ServeSimulator(cfg, getattr(sim_mod, preset)(**kw), **hw)
    if fail:  # pair 0 dies at t = 1 s; a spare pair joins at t = 0
        sim.inject_failure(1.0, wid=0)
        sim.add_worker()
    summary = sim.run(_trace(pkg, fail))
    return summary, sim.trace, [dataclasses.asdict(r) for r in sim.monitor.completed]


@pytest.mark.parametrize("preset, kw, fail, arch", [
    ("streamserve_config", {}, False, "llama2-7b"),
    ("streamserve_config", {"adaptive": False, "fixed_depth": 3}, False, "llama2-7b"),
    ("streamserve_config", {"speculative": False}, False, "llama2-7b"),
    ("streamserve_config", {"router": "roundrobin"}, False, "llama2-7b"),
    ("streamserve_config", {"router": "random"}, False, "llama2-7b"),
    ("vllm_tp_config", {"speculative": True, "fixed_depth": 3}, False, "llama2-7b"),
    ("vllm_dp_config", {}, False, "llama2-7b"),
    ("streamserve_config", {"nixl": False}, False, "llama2-7b"),
    ("streamserve_config", {}, True, "llama2-7b"),
    ("vllm_tp_config", {"speculative": True, "fixed_depth": 5}, False, "jamba-1.5-large-398b"),
    ("streamserve_config", {"nixl": False}, False, "mamba2-2.7b")],
    ids=["adaptive", "fixed", "no-spec", "roundrobin", "random", "vllm-tp", "vllm-dp",
         "host-staged", "failure-add-worker", "vllm-tp-jamba", "host-staged-mamba2"])
def test_simulator_matches_the_reference(preset, kw, fail, arch):
    """Every cost term on the path: prefill, decode and verify steps, the
    draft's steps, KV (and SSM state) transfer over the link or through the
    host, the tensor-parallel lane's all-reduces at 4 devices a lane."""
    want = _run(jax_sim, jax_config(arch), preset, kw, fail, jax_workloads)
    got = _run(simulator, get_config(arch), preset, kw, fail, workloads, hw=TPU)
    assert got == want
    assert got[0]["n"] == (40 if fail else 60)
    assert simulator.ServeSimulator(get_config(arch)).cost.hw is H100_SXM


def test_extend_sequence_is_all_or_nothing_as_in_the_reference():
    """A pool of 6 blocks of 4: an extension that takes the last block and
    still falls short (rolled back, the block kept), then a free that lets
    it through."""
    seen = []
    for kv in (KVCacheManager(6, 4), JaxKV(6, 4)):
        kv.allocate_sequence("a", list(range(6)), extra_tokens=2)
        b = kv.allocate_sequence("b", list(range(10, 19)))
        seen.append([kv.extend_sequence("b", 12), len(b.block_ids), b.n_tokens, kv.free_blocks,
                     kv.free_sequence("a"), kv.extend_sequence("b", 12), b.n_tokens])
    assert seen[0] == seen[1] == [False, 4, 9, 0, None, True, 21]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cost_model_counts_and_prices_chunked_prefill_as_the_reference(arch):
    """``n_params`` and ``chunked_prefill_time`` against the reference's
    CostModel on its profile, float for float (tests/test_chunked_prefill.py's
    three cases among them: one chunk as long as the prompt is one-shot
    prefill, 64 chunks pay 64 dispatches, an empty prompt one)."""
    got, want = CostModel(get_config(arch), hw=TPU), JaxCostModel(jax_config(arch))
    assert got.n_params == want.n_params
    for args in ((512, 512), (512, 8), (0, 128), (1000, 96, 200), (5, 64), (4096, 1000, 900)):
        assert got.chunked_prefill_time(*args) == want.chunked_prefill_time(*args), args
    assert got.chunked_prefill_time(512, 512) == pytest.approx(got.prefill_time(512))
    assert got.chunked_prefill_time(512, 8) >= 64 * TPU.dispatch_overhead


@pytest.mark.parametrize("preset, overrides", [
    ("reduced_smoke", {"draft": "none", "seed": 4}),
    ("paper_stream_pairs", {"arch": "llama2-7b", "max_batch": 32}),
    ("reduced_smoke", {"spec_policy": "fixed", "fixed_depth": 3, "router": "roundrobin"})])
def test_to_sim_config_matches_the_reference(preset, overrides):
    for extra in ({}, {"nixl": False, "lane_chips": 2}):
        got = getattr(ServeConfig, preset)(**overrides).to_sim_config(**extra)
        want = getattr(jax_api.ServeConfig, preset)(**overrides).to_sim_config(**extra)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("example, kw", [
    ("quickstart_torch", {"steps": 24, "device": "cpu"}),
    ("train_resilient_torch", {"steps": 9, "device": "cpu"}),
    ("serve_cluster_torch", {"device": "cpu"}), ("spec_depth_study_torch", {})])
def test_example_runs_on_the_cpu_with_the_reference_checks(example, kw):
    """Each example asserts what its reference asserts (the loss falls; the
    restart replays exactly, compressed too, and compression tracks the
    uncompressed run within 0.1; every request completes after a failure,
    all 240 simulated ones after a failure and a scale-out)."""
    assert __import__(example).main(**kw)
