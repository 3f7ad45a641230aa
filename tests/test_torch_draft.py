"""The small-transformer draft lane (``draft="model"``, M8) and the paper's
ablation switches (round-robin routing, single-depth verify) in the port
against the JAX engine, in float32 on the reduced llama2 (MHA: one query
head a KV head, an untied head): token-identical greedy outputs, the same
``worker_id`` and equal ``RequestRecord``s.  On the card the draft lane runs
K2 on every admission and K1 at T = 1 on every proposal; ``chip_smoke.py``
holds the kernels to their plain versions.
"""
import dataclasses

import jax
import numpy as np
import pytest
from test_torch_engine import _copy, _engines, _serve, _serve_both, fp32_pair
from test_torch_engine import _one_torch_thread  # noqa: F401

import repro.api.config as jax_api
import repro.core.engine as jax_engine
import repro_torch.api.config as port_api
from repro.configs import get_config as jax_get_config
from repro_torch.api import ServeConfig, StreamServe
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import engine
from repro_torch.core.engine import ModelLaneDraft

MODEL = {"draft": "model"}
SINGLE = {"per_row_depth": False}
# case -> (engine overrides, trace, whether the port warms up first).  The
# model draft on the parity traces; single-depth verify with the verify
# buckets and without (every depth its own shape); round-robin routing; the
# Table 8/9 ablation row (fixed depth 4, no buckets, round-robin); n-gram
# drafts without buckets
CASES = {f"model-{t}": (MODEL, t, False) for t in ("bursty", "uniform", "mixed_slo")}
CASES.update({
    "model-warmup": (MODEL, "bursty", True),
    "single-depth-bucketed": ({**MODEL, **SINGLE}, "mixed_slo", False),
    "single-depth-unbucketed": ({**MODEL, **SINGLE, "verify_buckets": None}, "bursty", False),
    "per-row-unbucketed": ({**MODEL, "verify_buckets": None}, "mixed_slo", False),
    "roundrobin": ({**MODEL, "router": "roundrobin"}, "bursty", False),
    "ablation-fixed4": ({**MODEL, **SINGLE, "verify_buckets": None, "router": "roundrobin",
                         "spec_policy": "fixed", "fixed_depth": 4}, "mixed_slo", False),
    "ngram-single-depth-unbucketed": ({**SINGLE, "verify_buckets": None}, "bursty", False),
})


@pytest.fixture(scope="module")
def llama():
    """The reduced llama2 (2 layers) and a draft of the same family: its
    first layer, embedding and head (a random draft of its own agrees with
    the target on almost no token), each in the reference and the port."""
    jcfg, jparams, tcfg, tparams = target = fp32_pair("llama2-7b")
    small = {"n_layers": 1, "name": "llama2-7b-draft"}
    return target, (dataclasses.replace(jcfg, **small),
                    {**jparams, "blocks": jax.tree.map(lambda a: a[:1], jparams["blocks"])},
                    dataclasses.replace(tcfg, **small),
                    {**tparams, "layers": tparams["layers"][:1]})


def _counted(monkeypatch, module):
    """Record each verify step of ``module``'s engine: the draft tokens
    accepted and proposed over its active rows, and the proposal's width."""
    seen = []
    verify = module.verify_tokens

    def wrapped(*args, active, depth, **kw):
        res = verify(*args, active=active, depth=depth, **kw)
        act = np.asarray(active)
        d = np.full(act.shape, args[1].shape[1]) if depth is None else np.asarray(depth)
        seen.append((int(np.asarray(res.n_accepted)[act].sum()), int(d[act].sum()),
                     args[1].shape[1]))
        return res

    monkeypatch.setattr(module, "verify_tokens", wrapped)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_draft_and_ablations_match_jax_engine(llama, trace_factory, monkeypatch, case):
    econf, trace, warm = CASES[case]
    target, draft = llama
    jreqs = trace_factory(trace, n=6, max_new=10)
    treqs = _copy(jreqs)
    jeng, teng = _engines(target, 2, draft, **econf)
    if warm:
        teng.warmup()
    jseen, tseen = _counted(monkeypatch, jax_engine), _counted(monkeypatch, engine)
    _serve_both(jeng, teng, jreqs, treqs)
    assert tseen == jseen and sum(a for a, *_ in tseen) > 0  # some proposals accepted
    if econf.get("router") == "roundrobin":
        assert [r.worker_id for r in treqs] == [0, 1] * 3
    if econf.get("verify_buckets", 1) is None:  # verify ran at depth + 1, unpadded
        assert {w for *_, w in tseen} == {d for r in treqs for d in r.spec_depths} - {0}


class _IngestLast(ModelLaneDraft):
    """The draft also ingests its k-th proposal, so that a step accepting all
    k leaves its cache level with the target's."""

    def propose(self, pair, k):
        toks, q = super().propose(pair, k)
        self.lane.decode(toks[:, -1:].int())
        return toks, q

    def on_commit(self, pair, accept_idx, k):
        self.lane.commit(k + 1, accept_idx)


def test_self_draft_matches_reference_and_plain_decoding(llama, trace_factory, monkeypatch):
    """The target as its own draft: the same tokens as decoding without one,
    and the reference's acceptance step by step.  That is not 1.0: the
    reference's draft drops its k-th proposal after a full acceptance (ROADMAP
    §3).  A draft that ingests it accepts every proposal."""
    target = llama[0]
    jreqs = trace_factory("bursty", n=6, max_new=10)
    treqs, plain, level = _copy(jreqs), _copy(jreqs), _copy(jreqs)
    jeng, teng = _engines(target, 2, target, draft="model")
    jseen, tseen = _counted(monkeypatch, jax_engine), _counted(monkeypatch, engine)
    _serve_both(jeng, teng, jreqs, treqs)
    assert tseen == jseen
    accepted, proposed, _ = map(sum, zip(*tseen, strict=True))
    assert accepted < proposed
    _serve_both(*_engines(target, 2, draft="none"), _copy(jreqs), plain)
    tseen.clear()
    teng = _engines(target, 2, target, draft="model")[1]
    for pair in teng.pairs:
        pair.draft.__class__ = _IngestLast
    _serve(teng, level)
    accepted, proposed, _ = map(sum, zip(*tseen, strict=True))
    assert accepted == proposed > 0
    assert [r.output_tokens for r in treqs] == [r.output_tokens for r in plain] == [
        r.output_tokens for r in level]


# the reference's engine and the port's: (engine, api, index of the
# config and params in an fp32_pair, extra arguments)
SIDES = ((jax_engine, jax_api, 0, {}), (engine, port_api, 2, {"device": "cpu"}))
REFUSALS = {"paged": {"paged_kv": True, "kv_blocks": 256, "kv_block_size": 16},
            "chunked": {"prefill_chunk": 16}, "no-draft-model": {}, "serve-config-paged": {}}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_model_draft_refusals_match_the_reference(llama, case):
    """Paged KV, chunked prefill, a missing draft model, and paged KV in the
    ServeConfig: the port refuses the model draft with the reference's
    ValueError and message."""
    target, draft = llama
    messages = []
    for pkg, api, i, kw in SIDES:
        with pytest.raises(ValueError) as err:
            if case == "serve-config-paged":
                api.ServeConfig(paged_kv=True, draft="model")
            pkg.PipeServeEngine(*target[i:i + 2], n_pairs=1, draft_params=draft[i + 1],
                                draft_cfg=None if case == "no-draft-model" else draft[i],
                                econf=pkg.EngineConfig(max_batch=2, max_len=96, draft="model",
                                                       **REFUSALS[case]), **kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


PRESETS = {
    "paper-llama2-model": lambda api: api.ServeConfig.paper_stream_pairs("llama2-7b",
                                                                       draft="model"),
    "paper-default": lambda api: api.ServeConfig.paper_stream_pairs(),
    "ablation-0": lambda api: api.ServeConfig.ablation_fixed_depth(0, arch="llama2-7b"),
    "ablation-4-full": lambda api: api.ServeConfig.ablation_fixed_depth(
        4, reduced=False, router="roundrobin", per_row_depth=False, verify_buckets=None),
}


@pytest.mark.parametrize("name", list(PRESETS))
def test_presets_match_the_reference(name):
    """Each preset, and what it builds, equals the reference's."""
    import repro_torch.api as api

    port, ref = PRESETS[name](api), PRESETS[name](jax_api)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for build in ("build_arch_config", "build_draft_arch_config", "build_engine_config"):
        assert dataclasses.asdict(getattr(port, build)()) == dataclasses.asdict(
            getattr(ref, build)())


def test_llama2_config_matches_the_reference():
    cfg = get_config("llama2-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config("llama2-7b"))
    assert cfg.n_params() == jax_get_config("llama2-7b").n_params() == 6_738_411_520
    small = reduced_config("llama2-7b")
    assert small.n_heads == small.n_kv_heads == 4 and not small.tie_embeddings


def test_streamserve_builds_the_draft_lane():
    """The front end builds the draft (the reference's draft_layers, the
    port's init at seed + 1) on the pairs' device and serves with it; a
    given tree is used as it is."""
    config = ServeConfig.reduced_smoke(arch="llama2-7b", draft="model", router="roundrobin")
    serve = StreamServe(config, device="cpu")
    lane = serve.engine.pairs[1].draft.lane
    assert lane.model.cfg == config.build_draft_arch_config() and lane.model.device.type == "cpu"
    handles = [serve.submit(list(range(1, 21))) for _ in range(3)]
    assert [len(h.result()) for h in handles] == [config.max_new_tokens] * 3
    assert [h.request.worker_id for h in handles] == [0, 1, 0] and lane.calls["decode"]
    again = StreamServe(config, device="cpu", draft_params=lane.params)
    assert again.engine.pairs[0].draft.lane.params is lane.params
