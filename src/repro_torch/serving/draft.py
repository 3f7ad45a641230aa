"""Draft providers for speculative decoding (a copy of the n-gram and none
providers of ``repro.serving.draft``).

The engine consumes the per-pair :class:`EngineDraft` protocol.  The
small-transformer draft (``draft="model"``, ``ModelLaneDraft``) lives in
``core/engine.py`` next to the ``ModelLane`` whose cache protocol it mirrors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.api.registry import register_draft
from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass
class DraftContext:
    """What a draft factory may need to build a provider for one pair."""

    cfg: ArchConfig
    econf: Any                      # repro_torch.core.engine.EngineConfig
    draft_cfg: Optional[ArchConfig] = None  # the small 'model' draft, when given
    draft_params: Any = None
    device: Any = None                       # the pair's device, where a draft lane lives


class EngineDraft:
    """Per-pair speculative proposal provider.  The engine hands providers the
    owning ``StreamPair`` (its ``pending`` tokens, ``histories`` and
    generator).  ``max_depth`` caps the depth decision; a provider that
    cannot propose advertises 0 and the pair decodes one token per step."""

    max_depth: int = 1 << 30

    def on_admit(self, pair, batch, slots):
        """A batch of requests was prefilled (``slots`` maps batch row to
        decode slot; padded rows point past ``max_batch``)."""

    def propose(self, pair, k):
        """Return ``(tokens (B, k), q (B, k))`` draft proposals."""
        raise NotImplementedError

    def on_commit(self, pair, accept_idx, k):
        """The target accepted ``accept_idx`` tokens per row of the real
        depth ``k`` (bucket padding never reaches providers)."""

    def warmup(self, pair, prefill_batches):
        """Run the provider's own steps once (one dummy ``batch`` per prefill
        shape bucket the engine uses) and leave its state as it was."""


class NGramEngineDraft(EngineDraft):
    """Zero-FLOP suffix-match n-gram draft over each slot's token history.

    For each sequence, find the longest suffix (up to ``max_ngram``) of the
    context that re-occurs earlier in its history and propose the tokens
    that followed it, with q = 1 (a deterministic proposal, so the Leviathan
    ratio p/q is the target's own confidence in the token).
    """

    def __init__(self, max_ngram):
        self.max_ngram = max_ngram

    def propose_one(self, h, k):
        n = len(h)
        for g in range(min(self.max_ngram, n - 1), 0, -1):
            for s in range(n - g - 1, -1, -1):  # the latest earlier occurrence
                if h[s:s + g] == h[n - g:] and h[s + g:s + g + k]:
                    out = list(h[s + g:s + g + k])
                    return out + [out[-1]] * (k - len(out))
        return [h[-1] if h else 0] * k  # no match: repeat the last token

    def propose(self, pair, k):
        toks = np.stack([np.array(self.propose_one(h, k), np.int32) for h in pair.histories])
        return toks, np.ones_like(toks, np.float32)


class NoDraft(EngineDraft):
    """Disables speculation: forces plain autoregressive decode steps."""

    max_depth = 0


@register_draft("ngram")
def _make_ngram(ctx):
    return NGramEngineDraft(ctx.econf.max_ngram)


@register_draft("none")
def _make_none(ctx):
    return NoDraft()

