"""PipeServe-Engine on PyTorch — disaggregated prefill/decode execution
(paper §3.4, Alg 1 & 3); a port of the dense, paged and SSM paths of
``repro.core.engine``.

One :class:`StreamPair` = a prefill lane + a decode lane sharing one device;
the decode lane runs continuous batching over ``max_batch`` slots with
SpecuStream-governed speculative flows.  The shape discipline of the JAX
engine carries over, because it is what will let CUDA graphs capture a fixed
set of shapes:

* **Bucketed prefill** — prompts are right-padded to power-of-two length
  buckets and queued admissions fuse into one prefill call per tick.
* **Depth-bucketed verify** — the draft is padded to the smallest
  ``verify_buckets`` member >= the depth; ``verify_tokens`` masks the pad.
* **Preallocated device state** — the batched decode cache is allocated once
  and updated in place (where JAX donated it); ``pending`` next-tokens live
  on the device; ``admit`` and ``decode_iteration`` each make ONE bulk
  device->host copy.

With ``paged_kv`` the decode lane keeps a global page pool with per-row
block tables instead: admission prefills only each prompt's suffix past its
resident radix prefix, straight into pages, sequences grow page by page up
to ``max_context``, and pool pressure evicts and requeues a victim (or
truncates).  With ``prefill_chunk`` the prefill lane instead ingests one
fixed-size chunk a tick through one (R, C) step over dense staging rows, and
an earlier deadline can park a long prompt at a chunk boundary (EDF
preemption); a finished row moves into a decode slot (or, paged, into
pages).  A stack with SSM layers (Mamba2) admits one request per prefill
call at its exact prompt length, since the SSM state would absorb padding,
and is refused paged KV and chunking.  The small-transformer draft
(``draft="model"``, :class:`ModelLaneDraft`) keeps its own dense
``ModelLane`` per pair, which mirrors the target's admissions, so it is
refused paged KV and chunking too.  StreamTrace recording raises
``NotImplementedError`` naming its ROADMAP item.  The engine is
single-controller and deterministic given the request trace.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.registry import (register_draft, resolve_draft, resolve_router,
                                     resolve_spec_policy)
from repro_torch.configs.base import ArchConfig
from repro_torch.core import graphs
from repro_torch.core.metrics import PerformanceMonitor, RequestRecord
from repro_torch.core.scheduler import StreamScheduler, edf_deadline
from repro_torch.core.specustream import VERIFY_BUCKETS, SlotSignals, pad_to_bucket
from repro_torch.models import build_model
from repro_torch.models.attention import SPEC_MARGIN, cache_capacity
from repro_torch.obs.spans import request_phases
from repro_torch.serving.cost_model import H100_SXM, HardwareProfile, PrefillDelayEstimator
from repro_torch.serving.draft import DraftContext, EngineDraft
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import sample, sample_probs
from repro_torch.serving.speculative import verify_tokens


def resolve_device(device=None):
    """``None`` means the card.  Without CUDA that raises: the CPU is chosen
    explicitly (``device="cpu"``), never fallen back to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this machine; pass "
                           "device='cpu' to run the port on the CPU")
    return dev


def _terminal_record(req, now, kv_evicted=False,
                     cancelled=False):
    """Terminal RequestRecord (finish or cancel) with SLO and phase fields."""
    depths = req.spec_depths
    queued, prefill, decode, stall = request_phases(req)
    return RequestRecord(
        request_id=req.request_id, t_start=req.arrival_time, t_end=now,
        prompt_len=req.prompt_len, generated=len(req.output_tokens),
        token_times=list(req.token_times), worker_id=req.worker_id,
        kv_evicted=kv_evicted, kv_requeued=req.kv_requeued,
        slo_ttft=req.slo_ttft, slo_tpot=req.slo_tpot, cancelled=cancelled,
        mean_depth=sum(depths) / len(depths) if depths else 0.0,
        phase_queued=queued, phase_prefill=prefill, phase_decode=decode,
        phase_stall=stall,
    )


def _restart(req):
    """Forget a request's progress on its pair: it is queued again and
    restarts from scratch."""
    req.output_tokens.clear()
    req.token_times.clear()
    req.spec_depths.clear()
    req.prefill_active_ticks = 0
    req.state = RequestState.QUEUED


def attention_only(cfg):
    """Whether right-padding and cursor offsets are invisible to the stack:
    true for causal attention, false once an SSM layer carries state."""
    return all(kind == "attn" for kind in cfg.layer_kinds())


def _pow2_buckets(lo, hi):
    """Power-of-two shape buckets from ``lo`` up to (and including) ``hi``."""
    out, b = [], max(lo, 1)
    while b < hi:
        out.append(b)
        b *= 2
    return (*out, hi)


_LANES = itertools.count()  # lane serial numbers: a lane's own programs are keyed by it
# the programs that invoke the model, by the ``ModelLane.calls`` entry they count in
_CALLS = {"lane_decode": "decode", "lane_prefill": "prefill", "paged_admit": "prefill",
          "chunk_prefill": "prefill"}


def _sample_program(name, rows, lane, temperature):
    """The reference's sampler program ``name`` over (rows, V) logits of ``lane``."""
    return name, (rows, lane.model.cfg.padded_vocab, temperature)


def _bucket(n, buckets):
    """Smallest bucket >= n (n itself when oversize: correctness first)."""
    return next((b for b in buckets if b >= n), n)


class ModelLane:
    """A model, its batched decode cache (per-slot dense, or a page pool with
    ``paged=(n_pages, page_size, max_context)``) and the step bodies.
    ``steps`` is the longest decode step (the deepest verify bucket + 1),
    for which SSM layers keep per-token states.

    The cache is preallocated, every step updates it in place, and a reset
    empties it in place: its buffers keep their addresses for the lane's
    life.  Every step goes through :meth:`run`, which counts it under the
    reference programs it stands for and, on the card, replays its CUDA graph
    (``graphs``; None runs it eagerly, as on the CPU).  ``calls`` counts model
    invocations (paged admissions and chunk steps as "prefill"), so a run can
    show how many kernel launches to expect.
    """

    def __init__(self, cfg, params, max_batch, max_len, device, paged=None, steps=0):
        self.model = build_model(cfg, device)
        self.params = params
        self.max_batch, self.max_len, self.paged = max_batch, max_len, paged
        self.cache = (self.model.init_paged_cache(max_batch, *paged) if paged
                      else self.model.init_cache(max_batch, max_len, steps))
        self.calls = {"prefill": 0, "decode": 0}
        self.serial = next(_LANES)
        self.graphs = graphs.Graphs(device) if self.model.device.type == "cuda" else None

    def run(self, programs, fn, *inputs, gen=None, ahead=False):
        """One step standing for the reference's ``programs``, (name, shape
        key) pairs, the lane's own keyed by the lane too (the reference keys
        them by its model): counted, then ``fn(*inputs)`` replayed from its
        graph on the card (captured at first use) or run on the CPU.  The
        inputs are the tensors that change from call to call, on any device;
        ``gen`` is the generator ``fn`` draws from; all else ``fn`` reads it
        must find at the same address on every call.  ``ahead`` only
        captures (counted when it runs); ``fn`` None only counts."""
        key = tuple((name, (self.serial, *shape) if name in graphs.PER_LANE else shape)
                    for name, shape in programs)
        for name, k in () if ahead else key:
            graphs.PROGRAMS[name].add(k)
            if name in _CALLS:
                self.calls[_CALLS[name]] += 1
        if self.graphs is not None and fn is not None:
            return (self.graphs.capture if ahead else self.graphs)(key, fn, inputs, gen)
        if fn is not None and not ahead:
            return fn(*(t.to(self.model.device, non_blocking=True) for t in inputs))
        return None

    def decode(self, tokens):
        """Logits (B, T, V) of one decode step over the cache."""
        return self.run([("lane_decode", (tokens.shape[1],))], self.decode_body, tokens)

    def commit(self, n_new, accept_idx):
        """Roll back the last ``n_new`` ingested tokens to ``accept_idx``."""
        self.run([self.commit_program(n_new)], self.commit_body,
                 torch.tensor(n_new, dtype=torch.int32), accept_idx)

    def prefill(self, batch):
        """Eager prefill: (last logits (B, V), its cache).  A stack with SSM
        layers admits at each prompt's exact length, so this stays eager, and
        each new length counts as a program, as the reference retraces."""
        self.run([("lane_prefill", tuple(batch["tokens"].shape))], None)
        return self.model.prefill(self.params, {k: t.to(self.model.device)
                                                for k, t in batch.items()}, self.max_len)

    def decode_body(self, tokens):
        return self.model.decode_step(self.params, self.cache, tokens)

    def commit_body(self, n_new, accept_idx):
        self.model.commit_cache(self.cache, self.cache["len"] - n_new, accept_idx)

    def commit_program(self, T):
        """The reference's rollback program after a T-token step: one a lane,
        or one a width where SSM layers keep T per-token states."""
        return "lane_commit", (T,) if self.model.n_ssm else ()

    def insert_program(self, rows):
        """The reference's insert of ``rows`` prefill rows, keyed by shape."""
        return "tree_insert", (self.model.cfg, self.max_batch, self.max_len, rows)

    def rows(self, slot_ids):
        """(src, dst) of an insert: prefill row src[i] goes to decode slot
        dst[i]; ids >= max_batch mark padded admission rows, dropped.  Both
        keep the batch's length, the kept pairs repeated in the dropped ones'
        places, so one graph serves every admission of a shape (with none
        kept, as in warmup, row 0 goes to slot 0, which warmup resets)."""
        keep = np.flatnonzero(slot_ids < self.max_batch)
        src = np.resize(keep if len(keep) else [0], len(slot_ids))
        return torch.from_numpy(src), torch.from_numpy(slot_ids[src] % self.max_batch).long()

    def insert_body(self, src, dst, small_cache):
        """Copy prefill row src[i] into decode slot dst[i] (the KV and
        SSM-state transfer): every per-slot tensor the prefill cache has."""
        for name, t in small_cache.items():
            dim = 0 if name == "len" else 1  # the rest are stacked over layers
            self.cache[name].index_copy_(dim, dst, t.index_select(dim, src))

    def admit_body(self, src, dst, *batch):
        """Prefill ``batch`` (tokens[, lengths]) and insert its rows: the
        reference's ``_lane_prefill`` then ``_tree_insert_rows``."""
        logits, small = self.model.prefill(self.params, dict(zip(("tokens", "lengths"), batch)),
                                           self.max_len)
        self.insert_body(src, dst, small)
        return logits

    def paged_admit_body(self, tokens, lens, n_new):
        """Prefill row b's ``n_new[b]`` suffix tokens at cursor ``lens[b]``
        straight into its pages (the block tables are already installed):
        admission is the KV transfer.  Returns each row's logits (B, V) at
        its last suffix token."""
        last = (n_new.long() - 1).clamp(0, tokens.shape[1] - 1)
        return self.model.chunk_prefill(self.params, self.cache, tokens, lens, n_new,
                                        last)[:, 0]

    def chunk_body(self, cache, tokens, lens, n_new, row):
        """One (R, C) chunked-prefill step on the staging ``cache`` (the
        reference's ``_chunk_step``): row ``row`` ingests its ``n_new`` new
        tokens, the others idle at their cursors.  Returns that row's logits
        (1, V) at its last new token; the unembed runs on one position a
        row, not C."""
        last = (n_new.long() - 1).clamp_min(0)
        return self.model.chunk_prefill(self.params, cache, tokens, lens, n_new,
                                        last).index_select(0, row)[:, 0]

    def insert_pages_body(self, chunk_cache, page_ids, at):
        """Move chunk row ``at[0]`` (positions [0, max_len)) into the page
        pool as whole pages: page i of the row to ``page_ids[i]`` in every
        layer, where the pool's spare page takes the pages past the prompt
        (the reference's dropped writes); seed ``len[at[1]] = at[2]``."""
        ps = self.cache["k"].shape[2]
        for name in ("k", "v"):
            src = chunk_cache[name].index_select(1, at[:1])[:, 0]
            self.cache[name].index_copy_(1, page_ids, src.reshape(
                src.shape[0], -1, ps, *src.shape[2:]))
        self.cache["len"].index_copy_(0, at[1:2], at[2:].int())

    def reset_cache(self, cache=None):
        """Empty a cache (the lane's by default) in place: positions and
        block tables to -1, the rest to 0.  Its buffers keep their addresses,
        so the graphs captured on them stay valid."""
        for name, t in (self.cache if cache is None else cache).items():
            t.fill_(-1 if name in ("kv_pos", "bt") else 0)


@dataclasses.dataclass
class EngineConfig:
    """The fields and defaults of ``repro.core.engine.EngineConfig``."""

    max_batch: int = 8
    max_len: int = 512
    temperature: float = 0.0
    kv_blocks: int = 4096
    kv_block_size: int = 16
    draft: str = "ngram"
    max_ngram: int = 4
    adaptive: bool = True
    fixed_depth: int = 5
    spec_config: Any = None
    router: str = "flowguard"
    router_config: Any = None
    spec_policy: Optional[str] = None
    prefill_buckets: bool = True
    prefill_bucket_min: int = 16
    admit_batch: int = 4
    verify_buckets: Optional[Tuple[int, ...]] = VERIFY_BUCKETS
    prefill_chunk: Optional[int] = None   # chunked prefill: tokens a chunk; None = one-shot
    prefill_preempt: bool = True          # EDF preemption at chunk boundaries
    per_row_depth: bool = True
    slo_routing: bool = True
    paged_kv: bool = False                # global page pool + radix prefix reuse
    max_context: Optional[int] = None     # per-sequence ceiling when paged; None = max_len
    kv_evict_policy: str = "requeue"      # pool dry mid-decode: "requeue" or "truncate"
    trace: str = "off"                    # recording not ported yet (ROADMAP)
    trace_capacity: int = 4096
    trace_dir: Optional[str] = None

    def resolved_spec_policy(self):
        if self.spec_policy is not None:
            return self.spec_policy
        return "specustream" if self.adaptive else "fixed"


class StreamPair:
    """One disaggregated prefill+decode lane pair (paper Alg 3)."""

    def __init__(self, worker_id, cfg, params, econf,
                 monitor, device, draft_cfg=None, draft_params=None):
        self.worker_id, self.econf, self.monitor, self.device = worker_id, econf, monitor, device
        self._paged = paged = econf.paged_kv
        ps, vb = econf.kv_block_size, econf.verify_buckets
        # page headroom every row keeps ahead of its committed length: the
        # deepest verify writes bucket+1 tokens before the host can extend a
        # table, and writes past a row's table are dropped
        self._kv_margin = vb[-1] + 1 if vb else 9
        self._max_context = (econf.max_context or econf.max_len) if paged else econf.max_len
        self._pages_max = -(-self._max_context // ps)
        self.lane = ModelLane(cfg, params, econf.max_batch, econf.max_len, device,
                              (econf.kv_blocks, ps, self._max_context) if paged else None,
                              steps=self._kv_margin)
        self.kv = KVCacheManager(econf.kv_blocks, ps, serve_prefixes=paged,
                                 max_seq_blocks=self._pages_max if paged else None)
        # host mirror of the device block tables: admission and extension
        # edit it, _sync_bt() pushes it once per tick when dirty
        self._bt_host = np.full((econf.max_batch, self._pages_max), -1, np.int32)
        self._bt_dirty = False
        # eviction -> requeue callback (wired by PipeServeEngine to the
        # scheduler's resubmit_or_fail); None truncates instead
        self.requeue = None
        self.spec = resolve_spec_policy(econf.resolved_spec_policy(), config=econf.spec_config,
                                        fixed_depth=econf.fixed_depth)
        self.draft = resolve_draft(econf.draft, DraftContext(cfg, econf, draft_cfg, draft_params,
                                                             device))
        if type(self.draft).on_admit is not EngineDraft.on_admit:  # it mirrors admission
            for on, what, off in ((paged, "paged_kv", "paging"),
                                  (econf.prefill_chunk and attention_only(cfg), "prefill_chunk",
                                   "chunking")):
                if on:
                    raise ValueError(f"{what} is incompatible with drafts that mirror admission "
                                     f"state (draft='model'); use 'ngram'/'none' or disable {off}")
        # length bucketing needs padding to be invisible, which holds for
        # causal attention but not for SSM state (the reference's arch_ok)
        self._bucketed = econf.prefill_buckets and attention_only(cfg)
        self._len_buckets = _pow2_buckets(econf.prefill_bucket_min, self._max_context)
        self._admit_buckets = _pow2_buckets(1, max(econf.admit_batch, 1))
        # chunked prefill (off for SSM stacks, as the reference's arch gate):
        # every chunk step writes C positions from a multiple of C, so C must
        # divide the cache capacity or the last window wraps the ring onto
        # the prompt's head; under a sliding window the write burst is also
        # held to SPEC_MARGIN, the ring slack that keeps in-step writes from
        # evicting positions still inside the earliest query's window
        self._chunk = None
        self.chunk_rows: List[Optional[Request]] = []
        self.chunk_cursor = {}  # request_id -> tokens ingested so far
        if econf.prefill_chunk and attention_only(cfg):
            cap = cache_capacity(cfg, econf.max_len)
            C = min(econf.prefill_chunk, cap)
            if cfg.sliding_window is not None:
                C = min(C, SPEC_MARGIN)
            while cap % C:
                C -= 1
            self._chunk = C
            R = max(econf.admit_batch, 2)  # >= 2: one parked + one active
            self.chunk_rows = [None] * R
            self.chunk_cache = self.lane.model.init_cache(R, econf.max_len)
        B = econf.max_batch
        self.slot_req: List[Optional[Request]] = [None] * B
        # device-resident pending next-token per slot (sampled, not ingested)
        self.pending = torch.zeros(B, dtype=torch.int32, device=device)
        self.histories: List[List[int]] = [[] for _ in range(B)]
        self.acceptance = 0.7  # optimistic prior
        self.gen = torch.Generator(device=device).manual_seed(worker_id)
        self.healthy = True

    def free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def active_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def prefill_in_flight(self):
        """Requests parked or active in chunk rows (0 when chunking is off)."""
        return sum(r is not None for r in self.chunk_rows)

    @property
    def load(self):
        return len(self.active_slots()) / self.econf.max_batch

    def admit_cap(self):
        """How many admissions may fuse into one prefill call."""
        return max(self.econf.admit_batch, 1) if self._bucketed else 1

    def _to_dev(self, a):
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def reserve_kv(self, req):
        """Reserve KV blocks ahead of the prefill: prompt + max_new on the
        dense path; prompt + page margin when paged (the sequence then grows
        page by page), sharing the resident prefix unless the prompt is
        ingested by chunks, which recompute every row from position 0."""
        extra = self._kv_margin if self._paged else req.params.max_new_tokens
        alloc = self.kv.allocate_sequence(req.request_id, list(req.prompt), extra_tokens=extra,
                                          share=not (self._paged and self._chunk))
        if alloc is None:
            return False  # pool exhausted: stays queued
        req.cache_hit_tokens = alloc.shared_blocks * self.kv.block_size
        return True

    def prompt_fits(self, req):
        """Whether a request can EVER be admitted here: a paged prompt over
        the context ceiling would requeue forever, so it fails instead; so
        does a paged prompt over max_len when chunked (the staging rows hold
        max_len positions)."""
        n = len(req.prompt)
        return not self._paged or (
            n + self._kv_margin <= self._pages_max * self.econf.kv_block_size
            and (self._chunk is None or n <= self.econf.max_len))

    def next_reserved(self, scheduler, now):
        """The next queued request for this pair with its KV reserved, and
        whether the pool ran dry: then the request stays at the queue's head
        and None comes back, as it does for an empty queue.  A request that
        can never fit fails on the way."""
        while (req := scheduler.next_for_prefill(self.worker_id, now)) is not None:
            if not self.prompt_fits(req):
                scheduler.fail_request(req, now, "exceeds_max_context")
            elif self.reserve_kv(req):
                return req, False
            else:
                scheduler.prefill_queues[self.worker_id].appendleft(req)
                return None, True
        return None, False

    def _refresh_bt_row(self, slot, request_id):
        """Mirror a sequence's block ids into the host block table."""
        bids = self.kv.seqs[request_id].block_ids
        self._bt_host[slot, len(bids):] = -1
        self._bt_host[slot, :len(bids)] = bids
        self._bt_dirty = True

    def _sync_bt(self):
        """Push the host block tables to the device cache, in place (one
        copy per tick, only when a row changed)."""
        if self._bt_dirty:
            bt = self.lane.cache["bt"]
            self.lane.run([("set_bt", (self.lane.model.cfg, *bt.shape))], bt.copy_,
                          torch.from_numpy(self._bt_host))
            self._bt_dirty = False

    def admit(self, reqs, now):
        """Prefill a batch of KV-reserved requests in ONE bucketed call and
        move their KV into free decode slots (one bulk device->host copy)."""
        slots = self.free_slots()[: len(reqs)]
        if len(slots) != len(reqs):
            raise RuntimeError("admit() requires a free slot per request")
        for req in reqs:
            req.state, req.t_prefill_start = RequestState.PREFILLING, now
        if self._paged:
            first = self._admit_paged(reqs, slots)
        else:
            first = self._admit_dense(reqs, slots)
        self.pending[self._to_dev(np.asarray(slots, np.int64))] = first.to(torch.int32)
        for slot, req, tok in zip(slots, reqs, first.tolist(), strict=True):  # ONE copy
            self._seat(slot, req, tok, now)

    def _seat(self, slot, req, tok, now):
        """A prefilled request starts decoding in ``slot`` with its first token."""
        req.state = RequestState.DECODING
        req.t_prefill_end = req.t_first_token = now
        req.output_tokens.append(tok)
        req.token_times.append(now)
        self.slot_req[slot] = req
        self.histories[slot] = [*req.prompt, tok]
        self.spec.reset_slot(slot)  # fresh request, fresh EMA

    def _admit_dense(self, reqs, slots):
        longest = max(len(r.prompt) for r in reqs)
        if self._bucketed:
            S, Bb = _bucket(longest, self._len_buckets), _bucket(len(reqs), self._admit_buckets)
        else:  # exact shapes, one admission per call
            S, Bb = longest, 1
        tokens = np.zeros((Bb, S), np.int32)
        lengths = np.ones((Bb,), np.int32)  # pad rows: 1 garbage token
        slot_ids = np.full((Bb,), self.econf.max_batch, np.int32)  # >= max_batch: dropped
        slot_ids[: len(reqs)] = slots
        for i, req in enumerate(reqs):
            tokens[i, : len(req.prompt)] = req.prompt
            lengths[i] = len(req.prompt)
            req.state = RequestState.TRANSFERRING
        batch = {"tokens": torch.from_numpy(tokens)}
        if self._bucketed:
            batch["lengths"] = torch.from_numpy(lengths)
        first = self._prefill_step(batch, slot_ids)
        self.draft.on_admit(self, batch, slot_ids)
        return first[: len(reqs)]

    def _sampled(self, rows, programs, body, *inputs, ahead=False):
        """A lane step whose ``body`` returns logits (rows, V), with a token
        sampled from each row in the same graph: tokens (rows,) int32
        (``ahead``: only captured, for warmup)."""
        temperature = self.econf.temperature

        def step(*args):
            logits = body(*args)
            return sample(self.gen, logits, temperature).to(torch.int32), logits

        out = self.lane.run([*programs, _sample_program("sample", rows, self.lane, temperature)],
                            step, *inputs, gen=self.gen, ahead=ahead)
        return out and out[0]

    def _prefill_step(self, batch, slot_ids):
        """Prefill ``batch`` (CPU tensors), insert its rows into ``slot_ids``
        and sample each row's first token: one graph on an attention stack;
        an SSM stack prefills at the exact length, eagerly, then inserts and
        samples in one graph."""
        lane = self.lane
        src, dst = lane.rows(slot_ids)
        Bb, S = batch["tokens"].shape
        if not lane.model.n_ssm:
            return self._sampled(Bb, [("lane_prefill", (Bb, S)), lane.insert_program(Bb)],
                                 lane.admit_body, src, dst, *batch.values())
        return self._insert_sampled(src, dst, *lane.prefill(batch))

    def _insert_sampled(self, src, dst, logits, small, ahead=False):
        """Insert the rows of ``small`` (a prefill's cache, or the chunk
        rows', copied in) and sample a first token from each row of
        ``logits``: one graph (``ahead``: only captured, for warmup)."""
        def body(src, dst, logits, *state):
            self.lane.insert_body(src, dst, dict(zip(small, state)))
            return logits

        return self._sampled(len(logits), [self.lane.insert_program(len(src))], body, src, dst,
                             logits, *small.values(), ahead=ahead)

    def _admit_paged(self, reqs, slots):
        """ONE bucketed suffix prefill over the whole decode batch, straight
        into pages: each row starts at its resident-prefix cursor and only
        the suffix is computed; occupied rows ride along at their committed
        cursor with ``n_new = 0`` (their padding is shadowed by position)."""
        B = self.econf.max_batch
        S = _bucket(max(len(r.prompt) - r.cache_hit_tokens for r in reqs), self._len_buckets)
        tokens = np.zeros((B, S), np.int32)
        lens = np.zeros((B,), np.int32)
        n_new = np.zeros((B,), np.int32)
        for b, occupant in enumerate(self.slot_req):
            if occupant is not None:
                lens[b] = len(occupant.prompt) + len(occupant.output_tokens) - 1
        for req, slot in zip(reqs, slots, strict=True):
            suffix = req.prompt[req.cache_hit_tokens:]
            tokens[slot, : len(suffix)] = suffix
            lens[slot], n_new[slot] = req.cache_hit_tokens, len(suffix)
            self._refresh_bt_row(slot, req.request_id)
            req.state = RequestState.TRANSFERRING
        self._sync_bt()
        first = self._paged_step(tokens, lens, n_new)  # every row sampled, as the reference
        return first[self._to_dev(np.asarray(slots, np.int64))]

    def _paged_step(self, tokens, lens, n_new):
        """Paged admission and its first tokens, one graph (numpy inputs)."""
        return self._sampled(len(lens), [("paged_admit", tokens.shape)], self.lane.paged_admit_body,
                             *map(torch.from_numpy, (tokens, lens, n_new)))

    def _chunk_pull(self, scheduler, now):
        """Move queued requests into free chunk rows.  A row is granted only
        while free decode slots outnumber the occupied rows, so every row can
        claim a slot when it completes.  With preemption off one request is
        in flight at a time (run to completion); with it on, arrivals join
        eagerly so EDF can park work in progress."""
        while True:
            free = [r for r, rq in enumerate(self.chunk_rows) if rq is None]
            occupied = len(self.chunk_rows) - len(free)
            if not free or len(self.free_slots()) <= occupied:
                return
            if occupied and not self.econf.prefill_preempt:
                return
            req, _ = self.next_reserved(scheduler, now)
            if req is None:
                return
            req.state, req.t_prefill_start = RequestState.PREFILLING, now
            self.chunk_rows[free[0]] = req
            self.chunk_cursor[req.request_id] = 0

    def chunk_tick(self, scheduler, now):
        """One prefill-lane tick under chunked prefill: pull arrivals, serve
        ONE chunk to the earliest-deadline row (ties to the lowest row; the
        single row in flight without preemption), and move the row into a
        decode slot once its cursor reaches the prompt's end.  The chunk
        boundary is the preemption point: a parked row keeps its KV and its
        cursor, and resumes chunk-aligned."""
        self._chunk_pull(scheduler, now)
        occupied = [(r, rq) for r, rq in enumerate(self.chunk_rows) if rq is not None]
        if not occupied:
            return
        if self.econf.prefill_preempt:
            row, req = min(occupied, key=lambda t: (edf_deadline(t[1]), t[0]))
        else:
            row, req = occupied[0]
        C, R = self._chunk, len(self.chunk_rows)
        cur = self.chunk_cursor[req.request_id]
        req.prefill_active_ticks += 1  # a lane turn granted
        n = min(C, len(req.prompt) - cur)
        tokens = np.zeros((R, C), np.int32)
        tokens[row, :n] = req.prompt[cur:cur + n]
        lens = np.zeros((R,), np.int32)
        for r, rq in occupied:  # idle rows write padding at their own cursor
            lens[r] = self.chunk_cursor[rq.request_id]
        n_new = np.zeros((R,), np.int32)
        n_new[row] = n
        last = self._chunk_step(tokens, lens, n_new, row)
        self.chunk_cursor[req.request_id] = cur + n
        if cur + n >= len(req.prompt):
            self._chunk_complete(row, req, last, now)

    def _chunk_step(self, tokens, lens, n_new, row):
        """One chunk step over the staging rows (numpy inputs): row ``row``'s
        logits (1, V) at its last new token."""
        lane = self.lane
        return lane.run([("chunk_prefill", tokens.shape)],
                        lambda *a: lane.chunk_body(self.chunk_cache, *a),
                        *map(torch.from_numpy, (tokens, lens, n_new)), torch.tensor([row]))

    def _chunk_complete(self, row, req, last_logits, now):
        """The last chunk is in: move the row's KV into a free decode slot
        and sample the first token (one host copy)."""
        slot = self.free_slots()[0]  # guaranteed by _chunk_pull's budget
        req.state = RequestState.TRANSFERRING
        n_pages = -(-len(req.prompt) // self.econf.kv_block_size)
        bids = self.kv.seqs[req.request_id].block_ids[:n_pages] if self._paged else ()
        first = self._complete_step(last_logits, row, slot, bids, len(req.prompt))
        if self._paged:
            self._refresh_bt_row(slot, req.request_id)
        self.pending[slot] = first[0]
        self._seat(slot, req, int(first[0]), now)
        self.chunk_rows[row] = None
        del self.chunk_cursor[req.request_id]

    def _complete_step(self, last_logits, row, slot, block_ids, seq_len):
        """Chunk row ``row`` into decode slot ``slot`` (dense: the admission
        insert; paged: its pages ``block_ids`` into the pool, the rest of the
        row to the spare page) and the first token sampled: one graph."""
        lane, econf = self.lane, self.econf
        if not self._paged:
            slot_ids = np.full((len(self.chunk_rows),), econf.max_batch)
            slot_ids[row] = slot
            return self._insert_sampled(*lane.rows(slot_ids), last_logits, self.chunk_cache)
        page_ids = np.full((econf.max_len // econf.kv_block_size,), econf.kv_blocks)
        page_ids[:len(block_ids)] = block_ids

        def body(logits, *args):
            lane.insert_pages_body(self.chunk_cache, *args)
            return logits

        return self._sampled(1, [("insert_pages", (lane.model.cfg, *lane.cache["k"].shape))], body,
                             last_logits, torch.from_numpy(page_ids),
                             torch.tensor([row, slot, seq_len]))

    def release(self, request_id=None):
        """Take every request (or the one ``request_id``) out of its decode
        slot, then out of its chunk row, freeing its KV; returns them in that
        order."""
        out = []
        for slot, r in enumerate(self.slot_req):
            if r is not None and request_id in (None, r.request_id):
                out.append(r)
                self.kv.free_sequence(r.request_id)
                self.clear_slot(slot)
        return out + [self.chunk_release(row) for row, r in enumerate(self.chunk_rows)
                      if r is not None and request_id in (None, r.request_id)]

    def chunk_release(self, row):
        """Empty a chunk row without completing it (cancel, worker failure)
        and free its KV.  The parked cache rows are simply abandoned: the
        row's next occupant shadows them by position."""
        req = self.chunk_rows[row]
        self.chunk_rows[row] = None
        self.chunk_cursor.pop(req.request_id, None)
        self.kv.free_sequence(req.request_id)
        return req

    def decode_iteration(self, now):
        """One continuous-batching decode step (speculative when enabled).
        Returns the number of tokens emitted across the batch."""
        active = self.active_slots()
        if not active:
            return 0
        if self._paged:
            self._sync_bt()  # page-table edits land before any device step
        B = self.econf.max_batch
        throughput = self.monitor.workers[self.worker_id].recent_throughput
        # advances the flow state; its depth serves single-depth verify
        decision = self.spec.adapt(self.acceptance, self.load, throughput)
        vb = self.econf.verify_buckets
        # per-row depths: each slot picks from its own acceptance and TPOT
        # headroom, and the rows share the verify bucket >= the deepest row;
        # without buckets, or with per_row_depth off, every active row takes
        # the pair's single decision.  Depth is clamped to the deepest bucket
        # (paged: page margin - 1)
        per_row = self.econf.per_row_depth and vb is not None
        active_mask = np.isin(np.arange(B), active)
        rows = np.asarray(self.spec.select_depths(
            [None if r is None else SlotSignals(slo_tpot=r.slo_tpot, tpot=r.measured_tpot())
             for r in self.slot_req], self.load, throughput), np.int64) if per_row \
            else active_mask * decision.bucket_depth
        cap = self._kv_margin - 1 if vb or self._paged else self.draft.max_depth
        rows = np.minimum(rows, min(self.draft.max_depth, cap))
        k = int(rows.max())
        active_dev = self._to_dev(active_mask)

        if k == 0:  # plain autoregressive step
            nxt = self._plain_step(self.pending)
            self.pending = torch.where(active_dev, nxt, self.pending)
            nxt_h = nxt.tolist()  # the ONE decode round-trip
            return sum(self._emit(s, [nxt_h[s]], now) for s in active)

        # draft proposal at the real depth k, padded to a shape bucket (the
        # last token repeated, q = 1); n-gram proposals come from the host,
        # the model draft's stay on the device
        k_pad = pad_to_bucket(k, vb)
        draft, draft_q = self.draft.propose(self, k)
        draft, draft_q = torch.as_tensor(draft).to(torch.int32), torch.as_tensor(draft_q).float()
        if k_pad > k:
            draft = torch.cat([draft, draft[:, -1:].expand(-1, k_pad - k)], 1)
            draft_q = torch.cat([draft_q, draft_q.new_ones((B, k_pad - k))], 1)
        depth = (torch.from_numpy(rows.astype(np.int32)) if per_row  # heterogeneous, one shape
                 else torch.full((B,), k, dtype=torch.int32) if vb else None)
        for s in active:
            self.slot_req[s].spec_depths.append(int(rows[s]))
        res, host = self._verify_step(self.pending, draft, draft_q, active_dev, depth)
        self.draft.on_commit(self, res.accept_idx, k)
        self.pending = torch.where(active_dev, res.next_token.to(torch.int32), self.pending)
        host = host.tolist()  # the ONE decode round-trip: all host bookkeeping needs
        n_acc = [h[0] for h in host]
        if per_row:
            # each slot's fraction of ITS OWN depth feeds the per-slot EMA;
            # the pair-level EMA keeps the mean
            fracs = [n_acc[s] / max(int(rows[s]), 1) for s in active]
            for s, frac in zip(active, fracs, strict=True):
                if rows[s] > 0:
                    self.spec.observe_slot(s, frac)
            accepted = sum(fracs) / len(fracs)
        else:
            accepted = sum(n_acc[s] for s in active) / len(active) / max(k, 1)
        self.acceptance = 0.8 * self.acceptance + 0.2 * accepted
        return sum(self._emit(s, [*host[s][2:2 + n_acc[s]], host[s][1]], now) for s in active)

    def _plain_step(self, pending):
        """One token for every row: decode, the reference's no-op commit and
        sampling, one graph.  Returns the tokens (B,) int32."""
        lane = self.lane

        def body(pending):
            logits = lane.decode_body(pending[:, None])
            lane.commit_body(1, torch.zeros_like(pending))
            return logits[:, 0]

        return self._sampled(len(pending), [("lane_decode", (1,)), lane.commit_program(1)], body,
                             pending)

    def _verify_step(self, pending, draft, draft_q, active, depth=None):
        """The target's verify step over T = k + 1 tokens (pending, then the
        k drafts): decode, accept/reject and rollback, one graph.  Returns the
        VerifyResult and, for the one host copy, (B, 2 + k): accepted count,
        next token, the drafts."""
        lane, temperature = self.lane, self.econf.temperature
        B, k = draft.shape

        def step(pending, draft, draft_q, active, *depth):
            logits = lane.decode_body(torch.cat([pending[:, None], draft], 1))
            res = verify_tokens(self.gen, draft, draft_q, logits, active=active,
                                temperature=temperature, depth=depth[0] if depth else None)
            lane.commit_body(k + 1, res.accept_idx)
            return res, torch.cat([res.n_accepted[:, None], res.next_token[:, None],
                                   draft.long()], 1), logits

        programs = [("lane_decode", (k + 1,)), ("verify_tokens", (B, k, lane.model.cfg.padded_vocab,
                                                                 temperature, depth is None)),
                    lane.commit_program(k + 1)]
        return lane.run(programs, step, pending, draft, draft_q, active,
                        *(() if depth is None else (depth,)), gen=self.gen)[:2]

    def _emit(self, slot, tokens, now):
        """Host bookkeeping for one slot's freshly decoded tokens (the device
        values were already fetched in one bulk copy upstream)."""
        req = self.slot_req[slot]
        if req is None:
            return 0  # evicted this very tick by an earlier slot's grant
        if self._paged:
            # the committed stream trails the emitted one by one token (the
            # newest is pending, not ingested): the grant covers [previous
            # pending token, *accepted draft tokens]
            committed = [req.output_tokens[-1], *tokens[:-1]]
            granted = self.kv.extend_up_to(req.request_id, len(tokens), tokens=committed)
            while granted < len(tokens) and self._requeue_victim(slot, now):
                granted += self.kv.extend_up_to(req.request_id, len(tokens) - granted,
                                                tokens=committed[granted:])
        else:
            granted = self.kv.extend_up_to(req.request_id, len(tokens))
        count = 0
        for t in tokens[:granted]:
            if req.is_done():
                break
            req.output_tokens.append(t)
            req.token_times.append(now)
            self.histories[slot].append(t)
            count += 1
        # block pool ran dry mid-decode: truncate and finish gracefully
        evicted = granted < len(tokens) and not req.is_done()
        if req.is_done() or evicted:
            self._finish(slot, now, kv_evicted=evicted)
        elif self._paged:
            # restore the page margin for the next step; at the context
            # ceiling, or with the pool dry and nobody to evict, truncate
            status = "oom"
            while status == "oom":
                status, _ = self.kv.ensure_margin(req.request_id, self._kv_margin)
                if status == "oom" and not self._requeue_victim(slot, now):
                    break
            if status != "ok":
                self._finish(slot, now, kv_evicted=True)
            else:
                self._refresh_bt_row(slot, req.request_id)
        return count

    def _requeue_victim(self, protect, now):
        """Evict the lowest-priority active slot other than ``protect`` —
        latest EDF deadline first (best-effort sorts last), ties to the
        highest slot — and resubmit its request from scratch.  False when
        eviction is off or unwired, or nobody else is left (self-eviction
        would only regrow into the same dry pool)."""
        cands = [s for s in self.active_slots() if s != protect]
        if self.econf.kv_evict_policy != "requeue" or self.requeue is None or not cands:
            return False
        slot = max(cands, key=lambda s: (edf_deadline(self.slot_req[s]), s))
        req = self.slot_req[slot]
        self.kv.free_sequence(req.request_id)
        self.clear_slot(slot)
        _restart(req)
        req.kv_requeued += 1
        self.requeue(req, now)
        return True

    def _finish(self, slot, now, kv_evicted=False):
        req = self.slot_req[slot]
        req.state, req.t_end = RequestState.FINISHED, now
        self.kv.free_sequence(req.request_id)
        self.monitor.complete_request(_terminal_record(req, now, kv_evicted=kv_evicted))
        self.clear_slot(slot)

    def clear_slot(self, slot):
        """Release a slot's host bookkeeping (and its block-table row)."""
        self.slot_req[slot] = None
        self.histories[slot] = []
        self.spec.reset_slot(slot)
        if self._paged:
            self._bt_host[slot] = -1
            self._bt_dirty = True

    def warmup(self, max_prompt_len=None):
        """Run every steady-state shape once (the chunk step and its
        completion, or the prefill or paged-admission buckets, none on the
        exact-shape path of an SSM stack; verify depths; the plain step) ahead
        of traffic, then reset the lane.  Returns the number of distinct
        shapes exercised, counted as the reference counts its programs."""
        if self.active_slots() or self.prefill_in_flight():
            raise RuntimeError("warmup() resets the decode and chunk caches; call it "
                               "before serving")
        econf, B = self.econf, self.econf.max_batch
        state = self.gen.get_state()  # the steps draw from self.gen; put back below
        n, batches = 0, []  # batches: one a prefill shape, for the draft's warmup
        cap = min(max_prompt_len or self._max_context, self._max_context)
        if self._paged:  # all-(-1) tables: every page write goes to the spare page
            self._bt_dirty = True
            self._sync_bt()
        if self._chunk is not None:
            # ONE chunk-step shape covers every prompt length; the completion
            # runs too, its pages all to the spare (dense: into slot 0)
            R = len(self.chunk_rows)
            zeros = np.zeros(R, np.int32)
            self._complete_step(self._chunk_step(np.zeros((R, self._chunk), np.int32), zeros,
                                                 zeros, 0), 0, 0, (), 0)
            self.lane.reset_cache(self.chunk_cache)
            n += 1
        elif self._paged:
            for S in (b for b in self._len_buckets if b <= _bucket(cap, self._len_buckets)):
                self._paged_step(np.zeros((B, S), np.int32), *np.zeros((2, B), np.int32))
                n += 1
            n += 1  # the reference's block-table install program
        elif self.lane.model.n_ssm:  # the exact-shape admission's insert, counted when served
            self._insert_sampled(*self.lane.rows(np.full(1, B)),
                                 torch.zeros((1, self.lane.model.cfg.padded_vocab)),
                                 self.lane.model.init_cache(1, econf.max_len), ahead=True)
        elif self._bucketed:
            for S in (b for b in self._len_buckets if b <= _bucket(cap, self._len_buckets)):
                for Bb in self._admit_buckets:
                    batches.append({"tokens": torch.zeros((Bb, S), dtype=torch.int32),
                                    "lengths": torch.full((Bb,), S, dtype=torch.int32)})
                    self._prefill_step(batches[-1], np.full(Bb, B))  # every row dropped
                    n += 1
        zeros = torch.zeros(B, dtype=torch.int32)
        for d in econf.verify_buckets or ():
            self._verify_step(zeros, torch.zeros((B, d), dtype=torch.int32), torch.ones((B, d)),
                              zeros.bool(), zeros + d)
            n += 1
        self._plain_step(zeros)
        self.draft.warmup(self, batches)
        self.lane.reset_cache()
        self.pending = zeros.to(self.device)
        self.gen.set_state(state)
        return n + 1

    def publish_metrics(self, queue_depth):
        self.monitor.update_worker(
            self.worker_id, cache_hit_rate=self.kv.hit_rate,
            memory_utilization=self.kv.memory_utilization, queue_depth=queue_depth,
            active_load=self.load, acceptance_rate=self.acceptance)


class ModelLaneDraft(EngineDraft):
    """Small-transformer draft on its own :class:`ModelLane` (on the pair's
    device), mirroring the target's per-slot prefill/insert/commit cache
    protocol (the EAGLE-class production path).

    As in the reference, the k-th proposal is never ingested by the draft and
    its commit keeps at most k tokens, so after a step that accepts all k the
    draft's cache lacks that token (ROADMAP §3)."""

    def __init__(self, cfg, params, max_batch, max_len, temperature, device):
        self.lane = ModelLane(cfg, params, max_batch, max_len, device)
        self.temperature = temperature

    def on_admit(self, pair, batch, slots):
        lane = self.lane
        lane.run([("lane_prefill", tuple(batch["tokens"].shape)),
                  lane.insert_program(len(slots))], lane.admit_body, *lane.rows(slots),
                 *batch.values())

    def propose(self, pair, k):
        """k single-token decodes from the pair's pending tokens, each
        sampling the next from the draft's logits (one graph a token)."""
        lane, B = self.lane, len(pair.pending)
        toks = torch.empty((B, k), dtype=torch.long, device=pair.device)
        qs = torch.empty((B, k), device=pair.device)
        programs = [("lane_decode", (1,)),
                    _sample_program("sample_probs", B, lane, self.temperature)]
        cur = pair.pending
        for i in range(k):
            toks[:, i], qs[:, i], _ = lane.run(programs, lambda t: self._propose_one(pair.gen, t),
                                               cur, gen=pair.gen)
            cur = toks[:, i]
        return toks, qs

    def _propose_one(self, gen, tokens):
        logits = self.lane.decode_body(tokens[:, None].int())
        return (*sample_probs(gen, logits[:, -1], self.temperature), logits)

    def on_commit(self, pair, accept_idx, k):
        # the draft ingested [pending, d_1..d_{k-1}] during propose
        self.lane.commit(k, accept_idx.clamp_max(k - 1))

    def warmup(self, pair, prefill_batches):
        for batch in prefill_batches:  # every insert row dropped
            self.on_admit(pair, batch, np.full(len(batch["tokens"]), self.lane.max_batch))
        self.propose(pair, 1)
        self.lane.commit(1, torch.zeros_like(pair.pending))
        self.lane.reset_cache()


@register_draft("model")
def _make_model_draft(ctx):
    if ctx.draft_cfg is None or ctx.draft_params is None:
        raise ValueError("draft='model' requires draft_cfg and draft_params")
    e = ctx.econf
    return ModelLaneDraft(ctx.draft_cfg, ctx.draft_params, e.max_batch, e.max_len,
                          e.temperature, ctx.device)


class PipeServeEngine:
    """The StreamServe system on the PyTorch execution path (paper Alg 1).

    ``draft_cfg``/``draft_params`` are the small draft model of
    ``draft="model"``; ``device=None`` runs on the card and raises where
    there is none; ``hardware`` is the profile SLO routing prices queued
    prefill with.
    """

    def __init__(self, cfg, params, n_pairs=2,
                 econf=None, router=None, draft_cfg=None, draft_params=None, device=None,
                 hardware=H100_SXM):
        self.device = resolve_device(device)
        self.econf = econf = econf or EngineConfig()
        if econf.trace != "off":
            raise NotImplementedError("StreamTrace recording (ROADMAP) is not ported yet")
        if econf.paged_kv:  # the reference's paged gating (write-once pages: no window)
            for bad, what in (
                    (not attention_only(cfg), "an attention-only stack (SSM state is "
                                              "not positional, so it cannot live in pages)"),
                    (cfg.sliding_window is not None, "a model without a sliding window"),
                    (econf.max_len % econf.kv_block_size, "kv_block_size to divide max_len"),
                    ((econf.max_context or econf.max_len) < econf.max_len,
                     "max_context >= max_len"),
                    (econf.kv_evict_policy not in ("requeue", "truncate"),
                     "kv_evict_policy 'requeue' or 'truncate'")):
                if bad:
                    raise ValueError(f"paged_kv requires {what}")
        if router is None or isinstance(router, str):
            router = resolve_router(router or econf.router, config=econf.router_config)
        self._now = 0.0
        # program counts are relative to construction, as the reference's
        # (keys seen by earlier engines in the process do not count here)
        self._programs_base = graphs.counts()
        self.monitor = PerformanceMonitor(n_pairs, clock=lambda: self._now)
        self.pairs = [StreamPair(i, cfg, params, econf, self.monitor, self.device, draft_cfg,
                                 draft_params) for i in range(n_pairs)]
        # SLO routing prices queued prefill work in engine ticks via the cost
        # model, so TTFT slack is comparable with slo_ttft deadlines; chunked,
        # at the pairs' effective chunk (clamped, or None for an SSM stack)
        self._estimator = estimator = PrefillDelayEstimator(
            cfg, hw=hardware, max_batch=econf.max_batch, mean_context=max(econf.max_len // 2, 1),
            prefill_chunk=self.pairs[0]._chunk)
        self.scheduler = StreamScheduler(
            n_pairs, router, self.monitor, slo_routing=econf.slo_routing,
            delay_estimator=estimator.ticks if econf.slo_routing else None)
        if econf.paged_kv:
            # prefix-hit routing probes every pair's radix index per
            # submission; page pressure evicts through the scheduler
            self.scheduler.prefix_probe = self._prefix_score
            for pair in self.pairs:
                pair.requeue = self.scheduler.resubmit_or_fail
        if self.pairs[0]._chunk is not None:
            # routing sees requests parked in chunk rows: they left the queue
            # but still owe the lane one tick per chunk left
            self.scheduler.inflight_depth = lambda wid: self.pairs[wid].prefill_in_flight()
            self.scheduler.inflight_delay = self._chunk_backlog_ticks

    def _chunk_backlog_ticks(self, worker_id):
        """Lane turns a pair's chunk rows still owe (one chunk a tick)."""
        pair = self.pairs[worker_id]
        return float(sum(-(-(len(r.prompt) - pair.chunk_cursor[r.request_id]) // pair._chunk)
                         for r in pair.chunk_rows if r is not None))

    def _prefix_score(self, worker_id, req):
        """The prefill a pair's resident prefix would save this request, as
        the cost model's fraction in [0, 1]: FlowGuard's prefix-hit term."""
        hit = self.pairs[worker_id].kv.match_prefix(list(req.prompt))
        return self._estimator.saved_frac(len(req.prompt), hit) if hit else 0.0

    def submit(self, req):
        return self.scheduler.submit(req, self._now)

    def cancel(self, request_id):
        """Cancel a request that is queued, mid-chunked-prefill or mid-decode.
        Returns True if it was found and cancelled, False if unknown or
        already done."""
        req = self.scheduler.cancel(request_id) or next(
            (r for pair in self.pairs for r in pair.release(request_id)), None)
        if req is None:
            return False
        req.state, req.t_end = RequestState.CANCELLED, self._now
        self.monitor.complete_request(_terminal_record(req, self._now, cancelled=True))
        return True

    def fail_worker(self, worker_id):
        """Simulate a node failure: drop the pair and re-route its queued and
        in-flight work (in-flight restarts from scratch): the decode slots'
        requests first, then the chunk rows', in the reference's order, which
        decides their routing."""
        pair = self.pairs[worker_id]
        pair.healthy = False
        rerouted = self.scheduler.mark_unhealthy(worker_id, self._now)
        for req in pair.release():
            _restart(req)
            # FAILED with a terminal record when this was the last worker
            rerouted += self.scheduler.resubmit_or_fail(req, self._now)
        return rerouted

    def step(self):
        """One engine tick: admit + decode on every healthy pair."""
        self._now += 1.0  # logical time: one tick per step
        emitted = 0
        for pair in (p for p in self.pairs if p.healthy):
            wid = pair.worker_id
            if pair._chunk is not None:  # one chunk a tick, preemptible at its boundary
                pair.chunk_tick(self.scheduler, self._now)
            else:
                # stall-free admission: fill free slots from the queue, fusing up
                # to admit_cap() reserved requests into one bucketed prefill call
                while True:
                    batch: List[Request] = []
                    blocked = False
                    while len(batch) < min(len(pair.free_slots()), pair.admit_cap()):
                        req, blocked = pair.next_reserved(self.scheduler, self._now)
                        if req is None:
                            break
                        batch.append(req)
                    if batch:
                        pair.admit(batch, self._now)
                    if blocked or not batch:
                        break
            n = pair.decode_iteration(self._now)
            emitted += n
            self.monitor.record_tokens(wid, n, self._now)
            pair.publish_metrics(self.scheduler.queue_depth(wid))
        return emitted

    def drained(self):
        """True when nothing is queued, mid-chunked-prefill or decoding."""
        return self.scheduler.pending_total() == 0 and all(
            not p.active_slots() and not p.prefill_in_flight() for p in self.pairs if p.healthy)

    def chunk_progress(self):
        """request_id -> tokens ingested so far, for every request in a chunk
        row on any pair: the handle on parked partial prefills."""
        return {rid: cur for pair in self.pairs for rid, cur in pair.chunk_cursor.items()}

    def run_until_done(self, max_steps=10_000):
        for _ in range(max_steps):
            if self.drained():
                return
            self.step()
        raise RuntimeError("engine did not drain within max_steps")

    def warmup(self, max_prompt_len=None):
        """Run every shape bucket on every healthy pair ahead of traffic: on
        the card this captures every fixed-shape step's graph."""
        return sum(pair.warmup(max_prompt_len) for pair in self.pairs if pair.healthy)

    def jit_cache_sizes(self):
        """The reference's programs this engine brought in, by the
        reference's names (``repro.core.engine.PipeServeEngine.
        jit_cache_sizes``): after warmup, serving adds none."""
        base = self._programs_base
        return {name: n - base[name] for name, n in graphs.counts().items()}

    def jit_cache_total(self):
        return sum(self.jit_cache_sizes().values())
