"""The compiled-step contract: the port's program counts against the JAX
engine's, and the CUDA-graph bookkeeping of ``repro_torch.core.graphs``
driven on the CPU through a stand-in for ``torch.cuda.CUDAGraph``.

The stand-in records the aten ops a step runs while it is captured, on
copies of every tensor that existed before, so that the capture changes
nothing (``Graphs`` puts the generator back itself); each replay runs the
record on the real tensors and writes every result into the tensor the
capture produced, as a replayed CUDA graph rewrites its static outputs.  A
host sync inside a step raises, as it does under capture on the card.
"""
import jax
import pytest
import torch
from test_torch_engine import _copy, _engines, _records, _serve, fp32_pair
from test_torch_engine import _one_torch_thread  # noqa: F401
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.core import graphs
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd


class ReplayGraph(TorchDispatchMode):
    """A CUDA graph's capture and replay on the CPU (see the module note)."""

    def register_generator_state(self, gen):
        pass

    def capture_begin(self, pool=None):
        self.ops, self.outer, self.made = [], {}, set()
        self.__enter__()

    def capture_end(self):
        self.__exit__(None, None, None)

    def _outer(self, x):
        """A tensor from before the capture: the copy that takes its writes
        (the maps are keyed by the tensors themselves, held alive)."""
        if isinstance(x, torch.Tensor) and x not in self.made:
            if x not in self.outer:
                self.outer[x] = x.clone()
            return self.outer[x]
        return x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default):
            raise RuntimeError(f"{func} syncs with the host inside a captured step")
        args, kwargs = tree_map(self._outer, (args, kwargs or {}))
        out = func(*args, **kwargs)
        self.made.update(t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))
        self.ops.append((func, args, kwargs, out))
        return out

    def replay(self):
        env = {copy: real for real, copy in self.outer.items()}

        def now(x):
            return env.get(x, x) if isinstance(x, torch.Tensor) else x

        for func, args, kwargs, out in self.ops:
            args, kwargs = tree_map(now, (args, kwargs))
            env.update((o, g) for o, g in zip(tree_flatten(out)[0],
                                              tree_flatten(func(*args, **kwargs))[0], strict=True)
                       if isinstance(o, torch.Tensor))
        for *_, out in self.ops:  # views are written through their bases
            for o in tree_flatten(out)[0]:
                if isinstance(o, torch.Tensor) and o._base is None and env[o] is not o:
                    o.copy_(env[o])


PAGED = {"paged_kv": True, "kv_blocks": 256, "kv_block_size": 16}
# case -> (arch, engine overrides): every path's programs: bucketed dense
# (greedy and sampled), paged, chunked dense and paged, mamba2 at its exact
# prompt lengths, the model draft, and unbucketed shapes.  The dense case
# runs 2 pairs (the programs two pairs share and those each lane keeps; pair
# 1 fails mid-trace), the others 1
CASES = {"dense": ("qwen3-1.7b", {}), "sampled": ("qwen3-1.7b", {"temperature": 1.0}),
         "paged": ("qwen3-1.7b", PAGED), "chunked": ("qwen3-1.7b", {"prefill_chunk": 16}),
         "chunked-paged": ("qwen3-1.7b", {**PAGED, "prefill_chunk": 16}),
         "mamba2": ("mamba2-2.7b", {}), "draft": ("llama2-7b", {"draft": "model"}),
         "unbucketed": ("qwen3-1.7b", {"prefill_buckets": False, "verify_buckets": None})}


@pytest.fixture(scope="module")
def models():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = fp32_pair(arch)
        return made[arch]
    return get


def _lanes(pair):
    return (pair.lane, pair.draft.lane) if hasattr(pair.draft, "lane") else (pair.lane,)


def _run(models, case, reqs, stand_in=None):
    """Fresh engines of ``case``, JAX's and the port's, every program count
    from empty; with ``stand_in`` only the port's, every lane on stand-in
    graphs.  Each warms up to the longest prompt, then serves a copy of
    ``reqs`` (with 2 pairs, pair 1 failing at tick 3).  Returns the port's
    engine and, for each engine: the warmup's shape count, the program
    counts after warmup and after serving, the tokens and the records."""
    jax.clear_caches()
    for keys in graphs.PROGRAMS.values():
        keys.clear()
    arch, econf = CASES[case]
    target = models(arch)
    n_pairs = 2 if case == "dense" else 1
    engines = _engines(target, n_pairs, target if econf.get("draft") else (None,) * 4, **econf)
    for pair in engines[1].pairs if stand_in else ():
        for lane in _lanes(pair):
            lane.graphs = graphs.Graphs("cpu", stand_in)
    out = []
    for engine in engines[1:] if stand_in else engines:
        n = engine.warmup(max(len(r.prompt) for r in reqs))
        warm, treqs = engine.jit_cache_sizes(), _copy(reqs)
        _serve(engine, treqs, fail=(1, 3) if n_pairs == 2 else None)
        out.append((n, warm, engine.jit_cache_sizes(), [r.output_tokens for r in treqs],
                    _records(engine)))
    return engines[1], out


@pytest.mark.parametrize("case", list(CASES))
def test_graphs_replay_the_reference_programs(models, trace_factory, monkeypatch, case):
    """After warmup and after serving, jit_cache_sizes() equals the JAX
    engine's, name by name, and where every shape is bucketed serving adds
    nothing.  Every lane on stand-in graphs then serves as the eager port
    does: the same tokens and records (sampled too, seed for seed), program
    counts, and kernel launch counts (here the plain versions count), which
    the graphed engine gets from the deltas recorded at capture.  Warmup,
    serving, fail_worker and reset_cache keep every buffer a graph reads."""
    counters = [(m, name, getattr(m, name.replace("plain", "cuda"))) for m, name in (
        (da, "decode_attention_plain"), (da, "decode_attention_paged_plain"),
        (fa, "flash_attention_plain"), (ssd, "ssd_scan_plain"))]
    for module, name, counter in counters:
        def plain(*a, _f=getattr(module, name), _c=counter, **kw):
            _c.launches += 1
            return _f(*a, **kw)
        monkeypatch.setattr(module, name, plain)
    reqs, launches = trace_factory("bursty", n=6), []
    for stand_in in (None, ReplayGraph):
        for *_, counter in counters:
            counter.launches = 0
        teng, runs = _run(models, case, reqs, stand_in)
        launches.append([counter.launches for *_, counter in counters])
        if stand_in is None:
            (jn, jwarm, jafter, *jserved), eager = runs
            assert eager[:3] == (jn, jwarm, jafter) and sum(launches[0])
            assert eager[3:] == tuple(jserved) or case == "sampled"  # JAX draws other numbers
            assert jwarm == jafter or case in ("mamba2", "unbucketed")
    assert runs == [eager] and launches[1] == launches[0]
    buffers = [t for pair in teng.pairs for t in getattr(pair, "chunk_cache", {}).values()]
    for lane in (lane for pair in teng.pairs for lane in _lanes(pair)):
        buffers += [*lane.cache.values(), *(t for st, *_ in lane.graphs.steps.values() for t in st)]
    ptrs = [t.data_ptr() for t in buffers]
    teng.warmup()
    teng.pairs[0].lane.reset_cache()
    assert [t.data_ptr() for t in buffers] == ptrs and len(buffers) > 20
