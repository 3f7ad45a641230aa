"""Host-side KV block accounting and the prefix cache behind FlowGuard's
cache-hit-rate signal (the dense-mode part of ``repro.serving.kv_cache``).

Logical blocks of ``block_size`` tokens carry reference counts and content
hashes, so full prompt blocks are shared across requests.  On the dense path
this is pure accounting and the single source of truth for M_w (memory
utilisation) and C_w (prefix reuse).  Device page indices, the radix index
and resurrectable freed pages come with paged KV (ROADMAP M7).
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Dict, List, Optional


def chain_hashes(tokens, block_size):
    """Content-hash chain of the full blocks of ``tokens``: crc32 of the
    little-endian (parent, *block) ints, never the per-process-randomised
    builtin ``hash()``."""
    out: List[int] = []
    parent = 0
    for i in range(0, len(tokens) - len(tokens) % block_size, block_size):
        data = b"".join(int(t).to_bytes(8, "little", signed=True)
                        for t in (parent, *tokens[i:i + block_size]))
        parent = zlib.crc32(data)
        out.append(parent)
    return out


@dataclasses.dataclass
class SequenceAllocation:
    request_id: str
    block_ids: List[int]
    n_tokens: int
    shared_blocks: int  # prefix blocks reused from the pool


class KVCacheManager:
    """Per-worker block pool (refcounts, FIFO free list, content-hash
    sharing) with allocation per sequence and a prefix hit-rate EMA.  A
    freed block drops its hash, so freed contents never revive."""

    def __init__(self, n_blocks, block_size=16, hit_ema=0.7):
        self.n_blocks, self.block_size = n_blocks, block_size
        self.ref = [0] * n_blocks
        self.block_hash: List[Optional[int]] = [None] * n_blocks
        self.free = deque(range(n_blocks))
        self.hash_index: Dict[int, int] = {}  # content hash -> block id
        self.seqs: Dict[str, SequenceAllocation] = {}
        # optimistic prior + fast EMA: a cold worker must not look cache-poor
        # forever, or hit-rate-weighted routing herds traffic onto one worker
        self.hit_rate = 0.5
        self._hit_ema = hit_ema

    def _allocate(self, content_hash=None):
        """One block; a registered hash is shared (refcount + 1).  None when
        the pool is exhausted."""
        if content_hash in self.hash_index:
            bid = self.hash_index[content_hash]
            self.ref[bid] += 1
            return bid
        if not self.free:
            return None
        bid = self.free.popleft()  # FIFO: reuse the oldest-freed block
        self.ref[bid] = 1
        if content_hash is not None:
            self.block_hash[bid] = content_hash
            self.hash_index[content_hash] = bid
        return bid

    def _release(self, bid):
        if self.ref[bid] <= 0:
            raise RuntimeError(f"double free of block {bid}")
        self.ref[bid] -= 1
        if self.ref[bid] == 0:
            self.hash_index.pop(self.block_hash[bid], None)
            self.block_hash[bid] = None
            self.free.append(bid)

    def allocate_sequence(self, request_id, tokens,
                          extra_tokens=0):
        """Blocks for a prompt (+ planned generation); None on OOM."""
        hashes = chain_hashes(tokens, self.block_size)
        got: List[int] = []
        shared = 0
        for i in range(-(-(len(tokens) + extra_tokens) // self.block_size)):
            h = hashes[i] if i < len(hashes) else None
            before = self.hash_index.get(h)
            bid = self._allocate(h)
            if bid is None:
                for held in got:
                    self._release(held)
                return None
            shared += before is not None and before == bid
            got.append(bid)
        alloc = self.seqs[request_id] = SequenceAllocation(request_id, got, len(tokens), shared)
        if hashes:  # prompts under one block have no sharing chance: no vote
            hit = min(shared / len(hashes), 1.0)
            self.hit_rate = self._hit_ema * self.hit_rate + (1 - self._hit_ema) * hit
        return alloc

    def extend_up_to(self, request_id, n_new_tokens):
        """Grow a sequence by UP TO ``n_new_tokens``; returns how many were
        granted (short when the pool runs dry — the caller truncates)."""
        alloc = self.seqs[request_id]
        capacity = len(alloc.block_ids) * self.block_size - alloc.n_tokens
        while capacity < n_new_tokens:
            bid = self._allocate()
            if bid is None:
                break
            alloc.block_ids.append(bid)
            capacity += self.block_size
        granted = min(max(capacity, 0), n_new_tokens)
        alloc.n_tokens += granted
        return granted

    def free_sequence(self, request_id):
        alloc = self.seqs.pop(request_id, None)
        for bid in alloc.block_ids if alloc else ():
            self._release(bid)

    @property
    def memory_utilization(self):
        return (self.n_blocks - len(self.free)) / self.n_blocks if self.n_blocks else 0.0
