"""The 2-layer MLP of ``mnist_mlp`` (port of ``consensusml_tpu/models/mlp.py``).

Flatten, ``Dense(hidden)``, relu, ``Dense(classes)``, all f32. The modules
mirror the flax tree (``Dense_0``, ``Dense_1``, each a ``kernel`` of
shape (in, out) and a ``bias``), so :func:`.convert.mlp_from_flax` is a
flatten. The model has no dropout and no norm state, so ``model_state``
passes through the loss unchanged.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from consensusml_tpu_torch.models.losses import softmax_cross_entropy
from consensusml_tpu_torch.models.resnet import Dense

__all__ = ["MLP", "mlp_loss_fn"]


class MLP(nn.Module):
    """Flatten -> Dense(hidden) -> relu -> Dense(classes). ``in_features``
    is the flattened image (flax infers it at init: 784 for 28x28x1)."""

    def __init__(self, hidden: int = 256, classes: int = 10, in_features: int = 784, device=None):
        super().__init__()
        self.hidden, self.classes = hidden, classes
        self.Dense_0 = Dense(in_features, hidden, device=device)
        self.Dense_1 = Dense(hidden, classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32).reshape(x.shape[0], -1)
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def mlp_loss_fn(model: MLP):
    """``loss_fn(params, model_state, batch, generator) -> (loss,
    model_state)`` for the trainer: ``model`` (structure only; ``meta`` is
    fine) run with one worker's ``params`` (flax paths joined by dots) on
    ``batch["image"]``, the mean softmax cross-entropy of
    ``batch["label"]``. ``model_state`` and ``generator`` are unused."""

    def loss_fn(params, model_state, batch, generator):
        logits = functional_call(model, params, (batch["image"],))
        return softmax_cross_entropy(logits, batch["label"]), model_state

    return loss_fn
