"""In-step token sampling: temperature / top-p with per-request seeds.

Port of ``consensusml_tpu/serve/sampling.py``. :func:`adjusted_probs` is
the reference's sampling distribution op for op (temperature softmax,
nucleus mask renormalized, greedy one-hot at the lowest-index argmax when
``temperature <= 0``), so greedy decoding matches the reference token for
token.

**Random bits.** The reference keys each draw on JAX threefry
``fold_in(fold_in(PRNGKey(seed), position), tag)``. Here each draw is a
counter-based hash of ``(seed, position, tag, token index)`` computed
with int64 tensor ops (32-bit lanes, multiplications split so no
intermediate overflows), turned into a uniform in (0, 1) and a Gumbel
race over the log-probabilities. The same ``(seed, position)`` gives the
same token on the CPU and on the card, whatever else shares the batch, so
a stream replays from its seed. It does not give JAX's bits: equality
with the reference's sampled streams is not part of this port yet.
"""

from __future__ import annotations

import torch

__all__ = [
    "SAMPLE_TAG",
    "sampling_uniforms",
    "adjusted_probs",
    "categorical_from_probs",
    "sample_token",
]

SAMPLE_TAG = 0  # the reference's tag for ordinary next-token draws

_PROB_FLOOR = 1e-38
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``0 <= x < 2**32`` held in int64, split into
    16-bit halves so no product exceeds 2**48."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64-held 32-bit lanes."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def sampling_uniforms(
    seeds: torch.Tensor, positions: torch.Tensor, tag: int, vocab: int
) -> torch.Tensor:
    """Uniforms in (0, 1), shape ``seeds.shape + (vocab,)``, one per
    ``(seed, position, tag, token index)``."""
    seed = seeds.to(torch.int64) & _M32
    pos = positions.to(torch.int64) & _M32
    key = _mix32(seed ^ _mix32(_mul32(pos + 1, 0x9E3779B9)))
    key = _mix32(key ^ _mul32(torch.full_like(key, tag + 1), 0x27D4EB2F))
    idx = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    h = _mix32(key[..., None] ^ _mul32(idx + 1, 0x165667B1))
    # 23 bits + 0.5 is exact in f32, so u stays strictly inside (0, 1)
    return ((h >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def adjusted_probs(
    logits: torch.Tensor, temperature: torch.Tensor, top_p: torch.Tensor
) -> torch.Tensor:
    """The sampling distribution ``(..., V)`` (the reference's op sequence):
    softmax of ``logits / temperature`` with the nucleus mask — tokens
    whose cumulative mass before them (in descending-logit order, ties by
    index) is below ``top_p`` keep their renormalized probability — or,
    for ``temperature <= 0``, the one-hot at ``argmax`` (lowest index on
    ties)."""
    logits = logits.float()
    temperature = temperature.float()
    top_p = top_p.float()
    t = torch.where(temperature > 0, temperature, 1.0)[..., None]
    probs = torch.softmax(logits / t, dim=-1)
    p_keep = torch.clamp(top_p, 1e-6, 1.0)[..., None]
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_probs = torch.gather(probs, -1, order)
    prefix = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    keep = torch.empty_like(order, dtype=torch.bool).scatter_(-1, order, prefix < p_keep)
    masked = torch.where(keep, probs, 0.0)
    masked = masked / masked.sum(-1, keepdim=True)
    greedy = torch.nn.functional.one_hot(logits.argmax(-1), logits.shape[-1]).float()
    return torch.where((temperature > 0)[..., None], masked, greedy)


def categorical_from_probs(uniforms: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One token per row by a Gumbel race over ``log(probs)``; zero
    probabilities are ``-inf`` and never win, so a greedy one-hot row
    returns its argmax whatever the uniforms."""
    logp = torch.where(probs > 0, torch.log(torch.clamp(probs, min=_PROB_FLOOR)), -torch.inf)
    gumbel = -torch.log(-torch.log(uniforms))
    return (logp + gumbel).argmax(-1).to(torch.int32)


def sample_token(
    logits: torch.Tensor,  # (..., V)
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    seeds: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Next-token draw for ``logits`` rows at absolute ``positions`` — the
    one entry point the prefill and decode stages share."""
    probs = adjusted_probs(logits, temperature, top_p)
    u = sampling_uniforms(seeds, positions, SAMPLE_TAG, logits.shape[-1])
    return categorical_from_probs(u, probs)
