"""Loss functions (port of ``consensusml_tpu/models/losses.py``: the
classification and masked LM losses), computed in float32 whatever the
logits' dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["softmax_cross_entropy", "masked_lm_loss"]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the cross-entropy of integer class ``labels``
    (optax's ``softmax_cross_entropy_with_integer_labels``)."""
    logits = logits.to(torch.float32)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


def masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the positions where ``mask`` is 1:
    ``sum(ce * mask) / max(sum(mask), 1)`` (optax's
    ``softmax_cross_entropy_with_integer_labels`` per token)."""
    logits = logits.to(torch.float32)
    per_tok = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long(), reduction="none"
    ).reshape(labels.shape)
    mask = mask.to(torch.float32)
    return (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)
