"""CUDA graphs over the engine's fixed-shape steps: the port of the JAX
engine's compiled-step contract (``repro.core.engine``: its module-level jits
and ``jit_cache_sizes``).

A lane step is a function of a few small input tensors over buffers that
live as long as the lane: the weights and the caches, which are reset in
place and so keep their addresses.  Every call names the reference programs
it stands for (``_lane_decode`` at T, ``sample`` at (B, V), ...), keyed as
the reference's jit caches key them, and :data:`PROGRAMS` gathers the keys
this process has seen: the engine's ``jit_cache_sizes()`` counts them.  On
the CPU the step then runs eagerly.  On a CUDA device a lane's
:class:`Graphs` captures it once per key into a ``torch.cuda.CUDAGraph`` and
replays it:

* the inputs are copied into static buffers the graph owns before every
  replay; the outputs are buffers the graph rewrites at the end of every
  replay, so a caller reads them before the step runs again;
* all graphs share one memory pool for what lives only inside a replay, and
  are replayed in any order, so nothing that outlives a replay may sit in
  it: the inputs, the outputs and the caches are allocated outside (a first
  capture, thrown away, shows what the outputs are);
* a step that draws random numbers registers the pair's generator, whose
  state is saved before the capture and restored after it, so the replays
  draw what the eager step would, seed for seed;
* the kernels' launch counters run in Python, at capture only: the capture
  records how far each moved and puts it back, and every replay adds that;
* capture runs on one side stream.

A step that fails to capture raises: the card never runs it eagerly instead.
"""
from __future__ import annotations

import gc
import weakref

import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd

# the reference's hot-path jits (PipeServeEngine._module_jit_sizes), and the
# ones keyed by the lane they run on (the reference keys them by its model)
NAMES = ("tree_insert", "paged_admit", "set_bt", "insert_pages", "verify_tokens", "sample",
         "sample_probs", "lane_prefill", "lane_decode", "lane_commit", "chunk_prefill")
PER_LANE = {"paged_admit", "lane_prefill", "lane_decode", "lane_commit", "chunk_prefill"}
PROGRAMS = {name: set() for name in NAMES}
COUNTERS = (da.decode_attention_cuda, da.decode_attention_paged_cuda,
            fa.flash_attention_cuda, ssd.ssd_scan_cuda)
# device -> [side stream, memory pool, the Graphs holding graphs in it]
_shared = {}


def counts():
    """Programs seen so far in this process, by name."""
    return {name: len(keys) for name, keys in PROGRAMS.items()}


def pool(device):
    """The memory pool the graphs on ``device`` capture into (None before
    the first capture): what a measurement sizes them by."""
    return _shared.get(torch.device(device), [None, None])[1]


def _stream_and_pool(graphs):
    """The side stream captures run on and the memory pool they fill, one
    each for every lane on ``graphs``'s device.  Made at the first capture,
    after cuBLAS has made its handle and workspace (inside a capture it
    cannot); the pool anew once every graph of the last one is gone (a pool
    dies with its last graph)."""
    dev = graphs.device
    if dev not in _shared:
        side = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            for dt in (torch.float32, torch.bfloat16):
                torch.ones((2, 8, 8), dtype=dt, device=dev).matmul(
                    torch.ones((8, 8), dtype=dt, device=dev))
        _shared[dev] = [side, None, weakref.WeakSet()]
    shared = _shared[dev]
    if not shared[2]:
        shared[1] = torch.cuda.graph_pool_handle()
    shared[2].add(graphs)
    return shared[:2]


def _launches():
    return [(fn.launches, fn.wgmma_launches) for fn in COUNTERS]


class Graphs:
    """One lane's captured steps by key.  ``graph`` makes a graph:
    ``torch.cuda.CUDAGraph``, or a stand-in that replays on the CPU."""

    def __init__(self, device, graph=None):
        self.device, self.graph = torch.device(device), graph or torch.cuda.CUDAGraph
        self.steps = {}

    def __call__(self, key, fn, inputs, gen=None):
        static, graph, out, moved = self.capture(key, fn, inputs, gen)
        for buf, t in zip(static, inputs, strict=True):
            buf.copy_(t, non_blocking=True)
        graph.replay()
        for fn_, (n, w) in zip(COUNTERS, moved, strict=True):
            fn_.launches += n
            fn_.wgmma_launches += w
        return out

    def capture(self, key, fn, inputs, gen=None):
        """The step's graph, captured at its first call or ahead of it."""
        if key not in self.steps:
            self.steps[key] = self._capture(fn, inputs, gen)
        return self.steps[key]

    def _capture(self, fn, inputs, gen):
        static = [t.to(self.device, copy=True) for t in inputs]
        state, before, out = gen and gen.get_state(), _launches(), None
        stream, pool = _stream_and_pool(self) if self.device.type == "cuda" else (None, None)
        kept = []  # the first graph lives until the second holds the pool
        for _ in range(2):  # the first capture only shows what the outputs are
            graph, mid = self.graph(), _launches()
            kept.append(graph)
            if gen is not None:
                graph.register_generator_state(gen)
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(self.device))
            collecting = gc.isenabled()
            gc.disable()  # a graph the collector frees mid-capture would break the capture
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool)
                try:
                    got = fn(*static)
                    if out is not None:  # outputs outlive a replay: they live out of the pool
                        for o, g in zip(tree_flatten(out)[0], tree_flatten(got)[0], strict=True):
                            if isinstance(o, torch.Tensor):
                                o.copy_(g)
                finally:
                    graph.capture_end()
                    if collecting:
                        gc.enable()
            if out is None:
                out = tree_map(lambda t: torch.empty_like(t) if isinstance(t, torch.Tensor)
                               else t, got)
        if stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(stream)
        moved = [(a - n, b - w) for (a, b), (n, w) in zip(_launches(), mid, strict=True)]
        for fn_, (n, w) in zip(COUNTERS, before, strict=True):
            fn_.launches, fn_.wgmma_launches = n, w
        if gen is not None:
            gen.set_state(state)
        return static, graph, out, moved
