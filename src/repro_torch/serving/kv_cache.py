"""Host-side KV block accounting, the radix prefix index and the prefix cache
behind FlowGuard's cache-hit-rate signal (a port of ``repro.serving.kv_cache``,
its ``BlockPool`` and ``RadixIndex`` folded into :class:`KVCacheManager`).

Logical blocks of ``block_size`` tokens carry reference counts and content
hashes, so full prompt blocks are shared across requests.  On the dense path
this is pure accounting.  In serve mode (``serve_prefixes=True``, paged KV)
block ids are device page indices, a radix index over the chain hashes
answers longest-resident-prefix probes for routing, and freed pages stay
resurrectable until the free list recycles them.  Either way this is the
single source of truth for M_w (memory utilisation) and C_w (prefix reuse).
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Dict, List, Optional


def _hash_block(parent, block):
    """One chain-hash link: crc32 of the little-endian (parent, *block) ints,
    never the per-process-randomised builtin ``hash()``."""
    return zlib.crc32(b"".join(int(t).to_bytes(8, "little", signed=True)
                               for t in (parent, *block)))


def chain_hashes(tokens, block_size):
    """Content-hash chain of the full blocks of ``tokens``."""
    out: List[int] = []
    parent = 0
    for i in range(0, len(tokens) - len(tokens) % block_size, block_size):
        parent = _hash_block(parent, tokens[i:i + block_size])
        out.append(parent)
    return out


@dataclasses.dataclass
class SequenceAllocation:
    request_id: str
    block_ids: List[int]
    n_tokens: int
    shared_blocks: int  # prefix blocks reused from the pool
    # incremental chain hash: ``last_hash`` covers the first ``n_hashed``
    # tokens; ``tail`` buffers committed tokens past the last full block
    last_hash: int = 0
    n_hashed: int = 0
    tail: List[int] = dataclasses.field(default_factory=list)
    private: bool = False  # chunked ingest's opt-out: never registered in the index


class KVCacheManager:
    """Per-worker block pool (refcounts, FIFO free list, content-hash
    sharing) with allocation per sequence and a prefix hit-rate EMA.

    Dense mode drops a freed block's hash.  Serve mode shares only the
    leading resident run of a prompt (the pages admission may skip), always
    leaves one prompt token to recompute (admission needs its logit), keeps
    freed hashes until the block is recycled, and caps one sequence at
    ``max_seq_blocks`` (the device block table's width).
    """

    def __init__(self, n_blocks, block_size=16, hit_ema=0.7,
                 serve_prefixes=False, max_seq_blocks=None):
        self.n_blocks, self.block_size = n_blocks, block_size
        self.serve_prefixes, self.max_seq_blocks = serve_prefixes, max_seq_blocks
        self.ref = [0] * n_blocks
        self.block_hash: List[Optional[int]] = [None] * n_blocks
        self.free = deque(range(n_blocks))
        self.hash_index: Dict[int, int] = {}  # chain hash -> block id
        self.parent_of: Dict[int, int] = {}   # chain hash -> parent link (radix)
        self.seqs: Dict[str, SequenceAllocation] = {}
        # optimistic prior + fast EMA: a cold worker must not look cache-poor
        # forever, or hit-rate-weighted routing herds traffic onto one worker
        self.hit_rate = 0.5
        self._hit_ema = hit_ema
        # monotonic counters, exported via Prometheus: cached freed blocks
        # revived by a prefix re-hit, and cached freed prefixes recycled
        self.resurrections = 0
        self.lazy_evictions = 0

    def _register(self, bid, h, parent):
        self.block_hash[bid] = h
        self.hash_index[h] = bid
        self.parent_of[h] = parent

    def _unregister(self, bid):
        h = self.block_hash[bid]
        if h is not None:
            del self.hash_index[h], self.parent_of[h]
            self.block_hash[bid] = None

    def _fresh(self, h=None, parent=0):
        """A block off the FIFO free list (None when dry); recycling a cached
        freed block drops its old hash.  Registers ``h`` if unclaimed."""
        if not self.free:
            return None
        bid = self.free.popleft()
        if self.block_hash[bid] is not None and self.ref[bid] == 0:
            self.lazy_evictions += 1
        self._unregister(bid)
        self.ref[bid] = 1
        if h is not None and h not in self.hash_index:
            self._register(bid, h, parent)
        return bid

    def _share(self, h):
        """Take one more reference on the block registered under ``h``,
        reviving a cached freed block off the free list."""
        bid = self.hash_index[h]
        if self.ref[bid] == 0:
            self.free.remove(bid)
            self.resurrections += 1
        self.ref[bid] += 1
        return bid

    def _release(self, bid):
        if self.ref[bid] <= 0:
            raise RuntimeError(f"double free of block {bid}")
        self.ref[bid] -= 1
        if self.ref[bid] == 0:
            if not self.serve_prefixes:
                self._unregister(bid)
            self.free.append(bid)

    def allocate_sequence(self, request_id, tokens, extra_tokens=0, share=True):
        """Blocks for a prompt (+ planned generation); None on OOM.  With
        ``share=False`` (serve mode) no page is shared or registered: the
        request writes every page and its hashes never enter the index."""
        bs = self.block_size
        hashes = chain_hashes(tokens, bs)
        total = -(-(len(tokens) + extra_tokens) // bs)
        if self.max_seq_blocks is not None and total > self.max_seq_blocks:
            return None
        max_shared = min(len(hashes), max(0, (len(tokens) - 1) // bs))
        got: List[int] = []
        shared = 0
        leading = True
        for i in range(total):
            h = hashes[i] if i < len(hashes) else None
            parent = hashes[i - 1] if 0 < i <= len(hashes) else 0
            resident = h in self.hash_index
            if not self.serve_prefixes:
                bid = self._share(h) if resident else self._fresh(h, parent)
                shared += resident
            elif share and leading and resident and shared < max_shared:
                bid = self._share(h)
                shared += 1
            else:  # a page this request writes; its hash is shared later
                leading = False
                bid = self._fresh(h if share and not resident else None, parent)
            if bid is None:
                for held in got:
                    self._release(held)
                return None
            got.append(bid)
        alloc = self.seqs[request_id] = SequenceAllocation(
            request_id, got, len(tokens), shared, last_hash=hashes[-1] if hashes else 0,
            n_hashed=len(hashes) * bs, tail=[int(t) for t in tokens[len(hashes) * bs:]],
            private=not share)
        if hashes:  # prompts under one block have no sharing chance: no vote
            hit = min(shared / len(hashes), 1.0)
            self.hit_rate = self._hit_ema * self.hit_rate + (1 - self._hit_ema) * hit
        return alloc

    def extend_sequence(self, request_id, n_new_tokens):
        """Grow a sequence by ``n_new_tokens``, all or nothing: on exhaustion
        the partial grant is rolled back (blocks taken so far stay attached
        for a later extend or free).  Returns whether it was granted."""
        granted = self.extend_up_to(request_id, n_new_tokens)
        if granted != n_new_tokens:
            self.seqs[request_id].n_tokens -= granted
        return granted == n_new_tokens

    def extend_up_to(self, request_id, n_new_tokens, tokens=None):
        """Grow a sequence by UP TO ``n_new_tokens``; returns how many were
        granted (short when the pool runs dry or the table is full — the
        caller truncates or evicts).  ``tokens``, the committed values the
        grant covers, feed the incremental chain hash in serve mode."""
        alloc = self.seqs[request_id]
        bs = self.block_size
        capacity = len(alloc.block_ids) * bs - alloc.n_tokens
        while capacity < n_new_tokens:
            if self.max_seq_blocks is not None and len(alloc.block_ids) >= self.max_seq_blocks:
                break
            bid = self._fresh()
            if bid is None:
                break
            alloc.block_ids.append(bid)
            capacity += bs
        granted = min(max(capacity, 0), n_new_tokens)
        alloc.n_tokens += granted
        if granted and tokens is not None and self.serve_prefixes and not alloc.private:
            alloc.tail.extend(int(t) for t in tokens[:granted])
            self._absorb_tail(alloc)
        return granted

    def _absorb_tail(self, alloc):
        """Chain-hash newly completed blocks (O(block) each) and register
        each one that is unclaimed, so generated blocks join the prefix cache."""
        bs = self.block_size
        while len(alloc.tail) >= bs:
            block, alloc.tail = alloc.tail[:bs], alloc.tail[bs:]
            h = _hash_block(alloc.last_hash, block)
            idx = alloc.n_hashed // bs
            if idx < len(alloc.block_ids):
                bid = alloc.block_ids[idx]
                if self.block_hash[bid] is None and h not in self.hash_index:
                    self._register(bid, h, alloc.last_hash)
            alloc.last_hash = h
            alloc.n_hashed += bs

    def ensure_margin(self, request_id, margin_tokens):
        """Pre-grow pages so the next ``margin_tokens`` device writes all land
        (writes past a row's table are dropped).  Returns ``(status, added)``:
        ``"ok"``, ``"ceiling"`` (table full) or ``"oom"`` (pool dry)."""
        alloc = self.seqs[request_id]
        need = -(-(alloc.n_tokens + margin_tokens) // self.block_size)
        added = 0
        while len(alloc.block_ids) < need:
            if self.max_seq_blocks is not None and len(alloc.block_ids) >= self.max_seq_blocks:
                return "ceiling", added
            bid = self._fresh()
            if bid is None:
                return "oom", added
            alloc.block_ids.append(bid)
            added += 1
        return "ok", added

    def match_prefix(self, tokens):
        """Tokens of the longest resident (consumable) prefix: the routing
        probe, a radix walk that allocates nothing."""
        if not self.serve_prefixes:
            return 0
        bs = self.block_size
        parent, n = 0, 0
        for i in range(max((len(tokens) - 1) // bs, 0)):
            h = _hash_block(parent, tokens[i * bs:(i + 1) * bs])
            if h not in self.hash_index or self.parent_of[h] != parent:
                break
            parent, n = h, n + bs
        return n

    def free_sequence(self, request_id):
        alloc = self.seqs.pop(request_id, None)
        for bid in alloc.block_ids if alloc else ():
            self._release(bid)

    @property
    def used(self):
        return self.n_blocks - len(self.free)

    @property
    def free_blocks(self):
        return len(self.free)

    @property
    def memory_utilization(self):
        return self.used / self.n_blocks if self.n_blocks else 0.0
