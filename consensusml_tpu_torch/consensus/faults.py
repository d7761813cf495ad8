"""Fault injection and failure detection for gossip (port of
``consensusml_tpu/consensus/faults.py``).

Semantics of a round with alive mask ``a`` (``(world,)`` of 0/1 floats):

    W'[i,j] = W[i,j] * a_j                 (j != i)
    W'[i,i] = 1 - sum_{j!=i} W[i,j] * a_j
    row i   = e_i                          when a_i = 0

A dead neighbour's weight folds back onto the receiver's self-weight and
a dead worker keeps its parameters. On a symmetric ``W`` the masked
matrix stays doubly stochastic, so the network mean is kept and nobody
blocks; a directed graph needs push-sum (:mod:`.pushsum`).

Two sources of the mask, composed by the trainer as ``alive = inject *
ok``:

- **Injection**: each worker misses a round with probability
  ``drop_prob``. The reference draws that flag from the worker's
  threefry key, which the port cannot reproduce. The port's contract
  instead: worker ``i``'s flag for round ``r`` is the ``r``-th draw of
  :func:`fault_generator` ``(seed, i)``, a host ``torch.Generator`` of
  that worker, separate from its dropout stream
  (``train.local_sgd.worker_generator``). So the simulated and the
  collective backend, the CPU and the card draw the same masks for the
  same seed, and reading a flag needs no copy from the device. Masks are
  never compared with the reference's draws: its tests pass them in.
- **Detection**: a worker whose local steps gave a non-finite loss,
  parameter or model-state value is dead for the round, and its local
  update is rolled back, so the NaN never reaches a neighbour.

``record_fault_metrics`` (the reference's telemetry counters) waits for
the port of the ``obs`` registry.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from consensusml_tpu_torch.utils import tree as T

__all__ = ["FaultConfig", "fault_generator", "draw_alive", "tree_all_finite", "masked_mixing_matrix"]


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-round fault model of one worker: ``drop_prob``, the chance it
    misses a gossip round; ``detect_nonfinite``, roll back and isolate a
    worker whose local steps went non-finite."""

    drop_prob: float = 0.0
    detect_nonfinite: bool = True

    def __post_init__(self):
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError(f"drop_prob must be in [0, 1), got {self.drop_prob}")


def fault_generator(seed: int, rank: int) -> torch.Generator:
    """Worker ``rank``'s host generator of injected faults for run ``seed``
    (a stream of its own, apart from the dropout generator)."""
    return torch.Generator().manual_seed((seed * 1000003 + rank) ^ 0x5F3759DF)


def draw_alive(gen: torch.Generator, drop_prob: float) -> float:
    """The next 0/1 flag of ``gen``: does this worker join the round? One
    uniform draw a round whatever ``drop_prob`` is, so a worker's stream
    stays in step across runs with and without faults."""
    u = float(torch.rand((), generator=gen))
    return 1.0 if drop_prob <= 0.0 or u >= drop_prob else 0.0


def tree_all_finite(loss: torch.Tensor, tree: Any) -> torch.Tensor:
    """0-dim f32 0/1 on ``loss``'s device: ``loss`` and every leaf of
    ``tree`` are finite (one reduction on the device, no host read)."""
    ok = torch.isfinite(loss).all()
    for leaf in T.leaves(tree):
        ok = ok & torch.isfinite(leaf).all()
    return ok.to(torch.float32)


def masked_mixing_matrix(w: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """``W'`` of the module docstring for an ``(n, n)`` mixing matrix and
    an ``(n,)`` 0/1 mask, the reference's elementwise steps in its order."""
    n = w.shape[0]
    alive = alive.to(device=w.device, dtype=w.dtype)
    wp = w * alive[None, :]
    wp = wp + torch.diag(1.0 - wp.sum(1))
    eye = torch.eye(n, dtype=w.dtype, device=w.device)
    return torch.where(alive[:, None] > 0, wp, eye)
