"""Speculative verification: batched Leviathan accept/reject (a port of
``repro.serving.speculative.verify_tokens``).

State: a committed cache plus one pending token y.  The target ingests
[y, d_1..d_k] in one decode step (logits L_0..L_k); draft token d_i is
accepted while u_i < p_i(d_i) / q_i; the first rejection resamples from
norm(max(p - q, 0)); if all are accepted a bonus comes from L_depth.
Greedy is exact.  For sampled drafts the residual uses the reference's
documented one-hot approximation q ~ onehot(d_i) * q_i.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.serving.sampling import token_probs


class VerifyResult(NamedTuple):
    n_accepted: torch.Tensor  # (B,) draft tokens accepted (0..k)
    next_token: torch.Tensor  # (B,) replacement or bonus token (new pending)
    accept_idx: torch.Tensor  # (B,) index of the last kept token among the T ingested


def _row(x, idx):
    """x (B, N, V) at per-row index idx (B,) -> (B, V)."""
    return x.gather(1, idx.long()[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


def verify_tokens(gen, draft_tokens,
                  draft_probs, target_logits,
                  active=None, temperature=0.0,
                  depth=None):
    """Accept/reject with per-row masking.

    draft_tokens/draft_probs (B, k); target_logits (B, k+1, V); ``depth``
    (B,) is each row's real depth <= k: positions >= depth are bucket padding
    and never accepted, and the bonus is read at ``depth``.
    """
    B, k = draft_tokens.shape
    V = target_logits.shape[-1]
    dev = target_logits.device
    p_full = token_probs(target_logits.reshape(B * (k + 1), V), temperature).view(B, k + 1, V)
    draft_tokens = draft_tokens.long()
    p_draft = p_full[:, :k].gather(-1, draft_tokens[..., None])[..., 0]   # (B, k)
    u = torch.rand((B, k), generator=gen, device=dev)
    ok = u < (p_draft / draft_probs.clamp_min(1e-30)).clamp_max(1.0)
    if depth is None:
        depth = torch.full((B,), k, dtype=torch.long, device=dev)
    else:
        depth = depth.long().expand(B)
        ok &= torch.arange(k, device=dev)[None, :] < depth[:, None]  # pad never accepted
    n_acc = ok.long().cumprod(-1).sum(-1)  # length of the accepted PREFIX
    rej_idx = torch.minimum(n_acc, depth - 1).clamp(0, k - 1)
    p_rej = _row(p_full, rej_idx)
    d_rej = draft_tokens.gather(1, rej_idx[:, None])[:, 0]
    q_rej = draft_probs.gather(1, rej_idx[:, None])[:, 0].to(p_rej.dtype)
    q_vec = torch.zeros_like(p_rej).scatter_(1, d_rej[:, None], q_rej[:, None])
    residual = (p_rej - q_vec).clamp_min(0.0)
    residual = residual / residual.sum(-1, keepdim=True).clamp_min(1e-30)
    next_p = torch.where((n_acc == depth)[:, None], _row(p_full, depth), residual)
    if temperature <= 0.0:
        nxt = next_p.argmax(-1)
    else:
        nxt = torch.multinomial(next_p, 1, generator=gen)[:, 0]
    if active is not None:
        n_acc = torch.where(active, n_acc, 0)
    return VerifyResult(n_accepted=n_acc, next_token=nxt, accept_idx=n_acc)
