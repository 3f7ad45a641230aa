"""Token sampling (the part of ``repro.serving.sampling`` the engine calls:
greedy or temperature; the engine never sets top-k/top-p).  Functions take
fp32 logits (B, V); sampled paths draw from the caller's generator."""
from __future__ import annotations

import torch


def token_probs(logits, temperature):
    """Full sampling distribution p(.) as probabilities (B, V)."""
    if temperature <= 0.0:  # greedy == one-hot argmax distribution
        one = torch.zeros_like(logits, dtype=torch.float32)
        return one.scatter_(-1, logits.argmax(-1, keepdim=True), 1.0)
    return torch.softmax(logits / max(temperature, 1e-6), dim=-1)


def sample(gen, logits, temperature=0.0):
    """Sample token ids (B,) from (B, V) logits."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    return torch.multinomial(token_probs(logits, temperature), 1, generator=gen)[:, 0]


def sample_probs(gen, logits, temperature=0.0):
    """Sample and return (token (B,), q(token) (B,)): the probability the
    sampler gave the token, which speculative verification needs of a draft."""
    probs = token_probs(logits, temperature)
    tok = (logits.argmax(-1) if temperature <= 0.0
           else torch.multinomial(probs, 1, generator=gen)[:, 0])
    return tok, probs.gather(-1, tok[:, None])[:, 0]
