"""Token sampling: greedy / temperature / top-k / top-p (a port of
``repro.serving.sampling``).  Functions take fp32 logits (B, V); sampled
paths draw from the caller's generator.  The engine calls ``sample`` and
``sample_probs`` with the defaults top_k = 0 and top_p = 1.0, which leave
the logits as they are."""
from __future__ import annotations

import torch


def apply_top_k(logits, k):
    """Mask every logit below the k-th largest of its row (k <= 0 or k >= V:
    no mask)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < thresh, -torch.inf)


def apply_top_p(logits, p):
    """Keep the smallest set of top tokens whose probability reaches p."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # a cutoff past the row (rounding keeps every cum < p) masks nothing
    idx = (cum < p).sum(-1, keepdim=True).clamp_max(logits.shape[-1] - 1)
    return logits.masked_fill(logits < sorted_logits.gather(-1, idx), -torch.inf)


def adjust_logits(logits, temperature, top_k, top_p):
    """Sampling-distribution logits (greedy is handled by the caller)."""
    logits = logits / max(temperature, 1e-6)
    return apply_top_p(apply_top_k(logits, top_k), top_p)


def token_probs(logits, temperature, top_k=0, top_p=1.0):
    """Full sampling distribution p(.) as probabilities (B, V)."""
    if temperature <= 0.0:  # greedy == one-hot argmax distribution
        one = torch.zeros_like(logits, dtype=torch.float32)
        return one.scatter_(-1, logits.argmax(-1, keepdim=True), 1.0)
    return torch.softmax(adjust_logits(logits, temperature, top_k, top_p), dim=-1)


def sample(gen, logits, temperature=0.0, top_k=0, top_p=1.0):
    """Sample token ids (B,) from (B, V) logits."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    return torch.multinomial(token_probs(logits, temperature, top_k, top_p), 1,
                             generator=gen)[:, 0]


def sample_probs(gen, logits, temperature=0.0, top_k=0, top_p=1.0):
    """Sample and return (token (B,), q(token) (B,)): the probability the
    sampler gave the token, which speculative verification needs of a draft."""
    probs = token_probs(logits, temperature, top_k, top_p)
    tok = (logits.argmax(-1) if temperature <= 0.0
           else torch.multinomial(probs, 1, generator=gen)[:, 0])
    return tok, probs.gather(-1, tok[:, None])[:, 0]
