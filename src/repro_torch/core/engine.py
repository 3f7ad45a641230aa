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
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.registry import (register_draft, resolve_draft, resolve_router,
                                     resolve_spec_policy)
from repro_torch.configs.base import ArchConfig
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


def _bucket(n, buckets):
    """Smallest bucket >= n (n itself when oversize: correctness first)."""
    return next((b for b in buckets if b >= n), n)


class ModelLane:
    """A model, its batched decode cache (per-slot dense, or a page pool with
    ``paged=(n_pages, page_size, max_context)``) and the step helpers.
    ``steps`` is the longest decode step (the deepest verify bucket + 1),
    for which SSM layers keep per-token states.

    The cache is preallocated and every step updates it in place; callers
    treat ``self.cache`` as the only live handle.  ``calls`` counts model
    invocations (paged admissions as "prefill"), so a run can show how many
    kernel launches to expect.
    """

    def __init__(self, cfg, params, max_batch, max_len, device, paged=None, steps=0):
        self.model = build_model(cfg, device)
        self.params = params
        self.max_batch, self.max_len, self.paged, self.steps = max_batch, max_len, paged, steps
        self.reset_cache()
        self.calls = {"prefill": 0, "decode": 0}

    def chunk_step(self, cache, tokens, lens, n_new, row, n):
        """One (R, C) chunked-prefill step on the staging ``cache`` (the
        counterpart of the reference's ``_chunk_step``): row ``row`` ingests
        its ``n`` new tokens, the others idle at their cursors.  Returns that
        row's logits (1, V) at its last new token; the unembed runs on one
        position a row, not C."""
        self.calls["prefill"] += 1
        last = torch.full((tokens.shape[0],), max(n - 1, 0), dtype=torch.long,
                          device=tokens.device)
        return self.model.chunk_prefill(self.params, cache, tokens, lens, n_new,
                                        last)[row:row + 1, 0]

    def insert_pages(self, chunk_cache, row, page_ids, slot, seq_len):
        """Move chunk row ``row`` (positions [0, max_len)) into the page pool
        as whole pages: page i of the row to ``page_ids[i]`` in every layer,
        where the pool's spare page takes the pages past the prompt (the
        reference's dropped writes); seed ``len[slot]``."""
        ps = self.cache["k"].shape[2]
        for name in ("k", "v"):
            src = chunk_cache[name][:, row]
            self.cache[name].index_copy_(1, page_ids, src.reshape(
                src.shape[0], -1, ps, *src.shape[2:]))
        self.cache["len"][slot] = seq_len

    def paged_admit(self, tokens, lens, n_new):
        """Prefill row b's ``n_new[b]`` suffix tokens at cursor ``lens[b]``
        straight into its pages (the block tables are already installed):
        admission is the KV transfer.  Returns each row's logits (B, V) at
        its last suffix token."""
        self.calls["prefill"] += 1
        last = (n_new.long() - 1).clamp(0, tokens.shape[1] - 1)
        return self.model.chunk_prefill(self.params, self.cache, tokens, lens, n_new,
                                        last)[:, 0]

    def prefill(self, batch):
        self.calls["prefill"] += 1
        return self.model.prefill(self.params, batch, self.max_len)

    def insert_rows(self, slot_ids, small_cache):
        """Copy prefill row r into decode slot ``slot_ids[r]`` (the KV and
        SSM-state transfer): every per-slot tensor the prefill cache has.
        Ids >= max_batch mark padded admission rows: dropped."""
        rows = np.nonzero(slot_ids < self.max_batch)[0]
        dev = self.cache["len"].device
        src = torch.from_numpy(rows).to(dev)
        dst = torch.from_numpy(slot_ids[rows].astype(np.int64)).to(dev)
        for name, t in small_cache.items():
            dim = 0 if name == "len" else 1  # the rest are stacked over layers
            self.cache[name].index_copy_(dim, dst, t.index_select(dim, src))

    def decode(self, tokens):
        self.calls["decode"] += 1
        return self.model.decode_step(self.params, self.cache, tokens)

    def commit(self, n_new, accept_idx):
        """Roll back the last ``n_new`` ingested tokens to ``accept_idx``."""
        self.model.commit_cache(self.cache, self.cache["len"] - n_new, accept_idx)

    def reset_cache(self):
        self.cache = (self.model.init_paged_cache(self.max_batch, *self.paged) if self.paged
                      else self.model.init_cache(self.max_batch, self.max_len, self.steps))


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
        self.pending = self._i32(B)
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
        return torch.from_numpy(a).to(self.device)

    def _i32(self, *shape, fill=0):
        """An int32 tensor of ``shape`` on the pair's device, filled."""
        return torch.full(shape, fill, dtype=torch.int32, device=self.device)

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
            self.lane.cache["bt"].copy_(torch.from_numpy(self._bt_host))
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
        batch = {"tokens": self._to_dev(tokens)}
        if self._bucketed:
            batch["lengths"] = self._to_dev(lengths)
        last_logits, small_cache = self.lane.prefill(batch)
        for req in reqs:
            req.state = RequestState.TRANSFERRING
        self.lane.insert_rows(slot_ids, small_cache)
        self.draft.on_admit(self, batch, slot_ids)
        return sample(self.gen, last_logits[: len(reqs)], self.econf.temperature)

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
        last = self.lane.paged_admit(self._to_dev(tokens), self._to_dev(lens),
                                     self._to_dev(n_new))
        first = sample(self.gen, last, self.econf.temperature)  # every row, as the reference
        return first[self._to_dev(np.asarray(slots, np.int64))]

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
        last = self.lane.chunk_step(self.chunk_cache, self._to_dev(tokens), self._to_dev(lens),
                                    self._to_dev(n_new), row, n)
        self.chunk_cursor[req.request_id] = cur + n
        if cur + n >= len(req.prompt):
            self._chunk_complete(row, req, last, now)

    def _chunk_complete(self, row, req, last_logits, now):
        """The last chunk is in: move the row's KV into a free decode slot
        (dense: the admission insert; paged: whole pages into the pool) and
        sample the first token (one host copy)."""
        slot = self.free_slots()[0]  # guaranteed by _chunk_pull's budget
        req.state = RequestState.TRANSFERRING
        if self._paged:
            ps, econf = self.econf.kv_block_size, self.econf
            bids = self.kv.seqs[req.request_id].block_ids
            n_pages = -(-len(req.prompt) // ps)
            page_ids = np.full((econf.max_len // ps,), econf.kv_blocks, np.int64)  # the spare
            page_ids[:n_pages] = bids[:n_pages]
            self.lane.insert_pages(self.chunk_cache, row, self._to_dev(page_ids), slot,
                                   len(req.prompt))
            self._refresh_bt_row(slot, req.request_id)
        else:
            slot_ids = np.full((len(self.chunk_rows),), self.econf.max_batch, np.int32)
            slot_ids[row] = slot
            self.lane.insert_rows(slot_ids, self.chunk_cache)
        first = sample(self.gen, last_logits, self.econf.temperature).to(torch.int32)
        self.pending[slot] = first[0]
        self._seat(slot, req, int(first[0]), now)
        self.chunk_rows[row] = None
        del self.chunk_cursor[req.request_id]

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

        if k == 0:  # plain autoregressive step (its commit would be a no-op)
            logits = self.lane.decode(self.pending[:, None])
            nxt = sample(self.gen, logits[:, 0], self.econf.temperature).to(torch.int32)
            self.pending = torch.where(active_dev, nxt, self.pending)
            nxt_h = nxt.tolist()  # the ONE decode round-trip
            return sum(self._emit(s, [nxt_h[s]], now) for s in active)

        # draft proposal at the real depth k, padded to a shape bucket (the
        # last token repeated, q = 1); n-gram proposals come from the host,
        # the model draft's stay on the device
        k_pad = pad_to_bucket(k, vb)
        draft, draft_q = self.draft.propose(self, k)
        draft = torch.as_tensor(draft, device=self.device).to(torch.int32)
        draft_q = torch.as_tensor(draft_q, device=self.device).float()
        if k_pad > k:
            draft = torch.cat([draft, draft[:, -1:].expand(-1, k_pad - k)], 1)
            draft_q = torch.cat([draft_q, draft_q.new_ones((B, k_pad - k))], 1)
        depth = (self._to_dev(rows.astype(np.int32)) if per_row  # heterogeneous, one shape
                 else self._i32(B, fill=k) if vb else None)
        for s in active:
            self.slot_req[s].spec_depths.append(int(rows[s]))
        # target verify step over T = k_pad + 1 tokens
        logits = self.lane.decode(torch.cat([self.pending[:, None], draft], 1))
        res = verify_tokens(self.gen, draft, draft_q, logits, active=active_dev,
                            temperature=self.econf.temperature, depth=depth)
        self.lane.commit(k_pad + 1, res.accept_idx)
        self.draft.on_commit(self, res.accept_idx, k)
        self.pending = torch.where(active_dev, res.next_token.to(torch.int32), self.pending)
        # the ONE decode round-trip: everything host bookkeeping needs at once
        host = torch.cat([res.n_accepted[:, None], res.next_token[:, None], draft.long()],
                         1).tolist()
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
        econf, dev = self.econf, self.device
        B = econf.max_batch
        gen = torch.Generator(device=dev).manual_seed(0)  # must not perturb self.gen
        n, batches = 0, []  # batches: one a prefill shape, for the draft's warmup
        cap = min(max_prompt_len or self._max_context, self._max_context)
        if self._paged:  # all-(-1) tables: every page write goes to the spare page
            self._bt_dirty = True
            self._sync_bt()
        if self._chunk is not None:
            # ONE chunk-step shape covers every prompt length; the completion
            # runs too, its pages all to the spare, its rows all dropped
            R = len(self.chunk_rows)
            last = self.lane.chunk_step(self.chunk_cache, self._i32(R, self._chunk), self._i32(R),
                                        self._i32(R), 0, 0)
            if self._paged:
                spare = torch.full((econf.max_len // econf.kv_block_size,), econf.kv_blocks,
                                   dtype=torch.long, device=dev)
                self.lane.insert_pages(self.chunk_cache, 0, spare, 0, 0)
            else:
                self.lane.insert_rows(np.full((R,), B, np.int32), self.chunk_cache)
            sample(gen, last, econf.temperature)
            self.chunk_cache = self.lane.model.init_cache(R, econf.max_len)
            n += 1
        elif self._paged:
            for S in (b for b in self._len_buckets if b <= _bucket(cap, self._len_buckets)):
                sample(gen, self.lane.paged_admit(self._i32(B, S), self._i32(B), self._i32(B)),
                       econf.temperature)
                n += 1
            n += 1  # the reference's block-table install program
        elif self._bucketed:
            for S in (b for b in self._len_buckets if b <= _bucket(cap, self._len_buckets)):
                for Bb in self._admit_buckets:
                    batches.append({"tokens": self._i32(Bb, S), "lengths": self._i32(Bb, fill=S)})
                    logits, small = self.lane.prefill(batches[-1])
                    self.lane.insert_rows(np.full((Bb,), B, np.int32), small)  # all dropped
                    sample(gen, logits, econf.temperature)
                    n += 1
        zeros = self._i32(B)
        for d in econf.verify_buckets or ():
            logits = self.lane.decode(self._i32(B, d + 1))
            verify_tokens(gen, self._i32(B, d), torch.ones((B, d), device=dev), logits,
                          active=zeros.bool(), temperature=econf.temperature, depth=zeros + d)
            self.lane.commit(d + 1, zeros)
            n += 1
        sample(gen, self.lane.decode(zeros[:, None])[:, 0], econf.temperature)
        self.draft.warmup(self, batches)
        self.lane.reset_cache()
        self.pending = zeros
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
        self.lane.insert_rows(slots, self.lane.prefill(batch)[1])

    def propose(self, pair, k):
        """k single-token decodes from the pair's pending tokens, each
        sampling the next from the draft's logits."""
        out = [(pair.pending, None)]
        for _ in range(k):
            out.append(sample_probs(pair.gen, self.lane.decode(out[-1][0][:, None].int())[:, -1],
                                    self.temperature))
        toks, qs = zip(*out[1:], strict=True)
        return torch.stack(toks, 1), torch.stack(qs, 1)

    def on_commit(self, pair, accept_idx, k):
        # the draft ingested [pending, d_1..d_{k-1}] during propose
        self.lane.commit(k, accept_idx.clamp_max(k - 1))

    def warmup(self, pair, prefill_batches):
        for batch in prefill_batches:  # every insert row dropped
            self.on_admit(pair, batch, np.full(len(batch["tokens"]), self.lane.max_batch))
        sample_probs(torch.Generator(device=pair.device).manual_seed(0),
                     self.lane.decode(pair.pending[:, None])[:, -1], self.temperature)
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
        """Run every shape bucket on every healthy pair ahead of traffic."""
        return sum(pair.warmup(max_prompt_len) for pair in self.pairs if pair.healthy)
