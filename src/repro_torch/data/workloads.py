"""Benchmark workload generators — the paper's four evaluation suites (a copy
of ``repro.data.workloads``; its ``TokenStream`` serves training, M10).

ALPACA (instruction following), GSM8K (math reasoning), HUMANEVAL (code
generation) and SUM (summarisation) are modelled by their serving-relevant
statistics: prompt and output length distributions, a shared instruction
prefix, and an acceptance profile.  Each request carries an *acceptance
process*, an AR(1) latent acceptance rate: what SpecuStream's flow vector
tracks.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np

from repro_torch.serving.request import Request, SamplingParams


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    name: str
    prompt_mean: float
    prompt_std: float
    output_mean: float
    output_std: float
    accept_base: float      # long-run acceptance rate of a draft token
    accept_vol: float       # AR(1) innovation scale (workload volatility)
    accept_rho: float       # AR(1) persistence
    shared_prefix: int      # tokens of shared instruction prefix (cache reuse)
    bimodal_hi: Optional[float] = None   # humaneval: second acceptance mode
    bimodal_frac: float = 0.0

    def sample_lengths(self, rng, n):
        p = np.maximum(rng.normal(self.prompt_mean, self.prompt_std, n).astype(int), 8)
        o = np.maximum(rng.normal(self.output_mean, self.output_std, n).astype(int), 8)
        return p, o

    def sample_accept_base(self, rng):
        if self.bimodal_hi is not None and rng.uniform() < self.bimodal_frac:
            return self.bimodal_hi
        return self.accept_base


# length statistics fitted to the paper's Eq-19 arithmetic (the reference's)
WORKLOADS = {
    "alpaca": WorkloadProfile("alpaca", 30, 15, 12, 6, accept_base=0.60, accept_vol=0.05,
                              accept_rho=0.90, shared_prefix=16),
    "gsm8k": WorkloadProfile("gsm8k", 65, 20, 24, 10, accept_base=0.67, accept_vol=0.12,
                             accept_rho=0.80, shared_prefix=24),
    "humaneval": WorkloadProfile("humaneval", 110, 40, 24, 12, accept_base=0.45,
                                 accept_vol=0.10, accept_rho=0.85, shared_prefix=8,
                                 bimodal_hi=0.90, bimodal_frac=0.55),
    "sum": WorkloadProfile("sum", 620, 180, 16, 6, accept_base=0.85, accept_vol=0.03,
                           accept_rho=0.95, shared_prefix=96),
}


@dataclasses.dataclass
class AcceptanceProcess:
    """Per-request AR(1) latent acceptance rate (what SpecuStream chases)."""

    base: float
    vol: float
    rho: float
    state: float = 0.0

    def step(self, rng):
        self.state = self.rho * self.state + rng.normal(0.0, self.vol)
        return float(np.clip(self.base + self.state, 0.05, 0.98))


@dataclasses.dataclass
class SimRequest:
    """A benchmark request: token ids and its latent acceptance process."""

    request: Request
    acceptance: AcceptanceProcess
    arrival: float


def sample_requests(workload, n=80, *, seed=0, vocab_size=32_000, arrival_rate=None,
                    max_new_override=None):
    """An n-query suite (paper §4) with Poisson arrivals (or all at once)."""
    prof = WORKLOADS[workload]
    # crc32, not the per-process-randomised builtin hash(): stable traces
    rng = np.random.default_rng(seed ^ (zlib.crc32(workload.encode()) & 0xFFFF))
    p_lens, o_lens = prof.sample_lengths(rng, n)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n)) if arrival_rate else np.zeros(n)
    shared = rng.integers(0, vocab_size, prof.shared_prefix).tolist()
    out = []
    for i in range(n):
        body = rng.integers(0, vocab_size, max(int(p_lens[i]) - prof.shared_prefix, 1))
        req = Request(prompt=shared + body.tolist(),
                      params=SamplingParams(max_new_tokens=int(max_new_override or o_lens[i])),
                      arrival_time=float(arrivals[i]))
        out.append(SimRequest(request=req, acceptance=AcceptanceProcess(
            base=prof.sample_accept_base(rng), vol=prof.accept_vol, rho=prof.accept_rho),
            arrival=float(arrivals[i])))
    return out


def make_workload(name, **kw):
    return sample_requests(name, **kw)


def sample_mixed(n_per_suite=20, *, seed=0, vocab_size=32_000, arrival_rate=None):
    """Multi-tenant trace interleaving all four suites: service times span
    short alpaca prefills to long sum prefills, so queue-blind placement
    piles long prefills ahead of short requests."""
    all_reqs = []
    for i, name in enumerate(WORKLOADS):
        all_reqs.extend(sample_requests(name, n_per_suite, seed=seed + i, vocab_size=vocab_size))
    rng = np.random.default_rng(seed)
    rng.shuffle(all_reqs)
    n = len(all_reqs)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n)) if arrival_rate else np.zeros(n)
    for sim, t in zip(all_reqs, arrivals, strict=True):
        sim.arrival = float(t)
        sim.request.arrival_time = float(t)
    return all_reqs


class TokenStream:
    """Deterministic, checkpointable synthetic token stream for training: a
    Markov bigram over the vocab with 10% random jumps, each step's batch
    drawn from its own seeded generator (so a replay from a checkpoint draws
    the same batches)."""

    def __init__(self, vocab_size, seq_len, batch, seed=0, shard=0, n_shards=1):
        self.vocab_size, self.seq_len, self.batch = vocab_size, seq_len, batch
        self.seed, self.shard, self.n_shards = seed, shard, n_shards
        self.step = 0
        k = min(8, vocab_size)  # a low branching factor: the loss drops within tens of steps
        self._next = np.random.default_rng(seed).integers(0, vocab_size, (vocab_size, k))

    def state_dict(self):
        return {"step": self.step, "seed": self.seed, "shard": self.shard}

    def load_state_dict(self, d):
        self.step = int(d["step"])

    def __next__(self):
        rng = np.random.default_rng((self.seed, self.step, self.shard, self.n_shards))
        toks = np.empty((self.batch, self.seq_len), np.int32)
        cur = rng.integers(0, self.vocab_size, self.batch)
        k = self._next.shape[1]
        for t in range(self.seq_len):
            toks[:, t] = cur
            choice = rng.integers(0, k, self.batch)
            jump = rng.uniform(size=self.batch) < 0.1
            cur = np.where(jump, rng.integers(0, self.vocab_size, self.batch),
                           self._next[cur, choice])
        self.step += 1
        return toks
