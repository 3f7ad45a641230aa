"""Request lifecycle objects shared by the real engine and the simulator."""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional, Sequence

_ids = itertools.count()


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    TRANSFERRING = "transferring"   # KV handoff prefill -> decode lane
    DECODING = "decoding"
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0        # 0 = greedy
    top_k: int = 0                  # 0 = off
    top_p: float = 1.0
    max_new_tokens: int = 128
    eos_token: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    request_id: str = dataclasses.field(default_factory=lambda: f"req-{next(_ids)}")
    # None = "not yet arrived"; the scheduler stamps submission time.  An
    # explicit value (including 0.0) is preserved verbatim.
    arrival_time: Optional[float] = None
    # per-request SLO targets (engine ticks on CPU, wall seconds on hardware);
    # None = best effort.  FlowGuard routes/sheds on slo_ttft, SpecuStream
    # budgets per-row speculation depth on slo_tpot.
    slo_ttft: Optional[float] = None
    slo_tpot: Optional[float] = None
    # runtime state ----------------------------------------------------------
    state: RequestState = RequestState.QUEUED
    worker_id: int = -1
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)
    # lifecycle stamps: None = "never happened".  0.0 is a REAL stamp (engine
    # tick 0 / simulator t=0) — consumers must guard with `is not None`, never
    # truthiness (a falsy check reported tick-0 first tokens as "no TTFT")
    t_prefill_start: Optional[float] = None
    t_prefill_end: Optional[float] = None
    t_first_token: Optional[float] = None
    t_end: Optional[float] = None
    error: Optional[str] = None
    # provenance for prefix caching
    cache_hit_tokens: int = 0
    # times this request was evicted from a full paged pool mid-decode and
    # re-queued from scratch (continuous batching under memory pressure)
    kv_requeued: int = 0
    # per-verify-step speculation depths this request ran at (observability
    # for the per-row depth controller; averaged onto its RequestRecord)
    spec_depths: List[int] = dataclasses.field(default_factory=list)
    # chunked-prefill lane turns actually granted to this request (one per
    # served chunk) — the span assembler splits the prefill window into
    # active service vs preemption stall with this; 0 on one-shot admission
    prefill_active_ticks: int = 0

    @property
    def prompt_len(self):
        return len(self.prompt)

    def measured_tpot(self):
        """Mean inter-token time so far; None until two tokens exist."""
        tt = self.token_times
        if len(tt) < 2 or tt[-1] <= tt[0]:
            return None
        return (tt[-1] - tt[0]) / (len(tt) - 1)

    def is_done(self):
        if len(self.output_tokens) >= self.params.max_new_tokens:
            return True
        eos = self.params.eos_token
        return eos is not None and len(self.output_tokens) > 0 and self.output_tokens[-1] == eos
