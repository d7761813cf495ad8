"""SlowMo outer optimizer: slow momentum on top of the gossip round (port of
``consensusml_tpu/train/outer.py``).

SlowMo (Wang et al. 2020) wraps the base decentralized round (local steps
then gossip) with a low-frequency momentum step on each worker's mixed
parameters ``y``, from the outer point ``x`` the round started at:

    d = x - y                 pseudo-gradient: what the round moved the params by
    u = beta * u + d          slow momentum
    x = x - alpha * u         slow step; the params become x

``beta=0, alpha=1`` is the identity (``x = y``). The step is elementwise
per worker, with no collective, so both backends run it on their own
rows. ``x`` and ``u`` are f32 and never alias the parameters (the local
steps update those in place). A worker whose round was rolled back and
missed the gossip comes back with ``y = x``: zero pseudo-gradient, its
momentum decays.

The arithmetic is the reference's compiled program's: XLA contracts
``beta * u + d`` and ``x - alpha * u`` into multiply-adds (one rounding
each, :func:`~consensusml_tpu_torch.compress.reference.fma_f32`), so the
port does too, a slice of elements at a time.
"""

from __future__ import annotations

import dataclasses

import torch

from consensusml_tpu_torch.compress.reference import fma_f32

__all__ = ["SlowMoConfig", "slowmo_init", "slowmo_update", "slowmo_update_"]

# elements one multiply-add pass takes at once (its f64 temporaries)
_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class SlowMoConfig:
    """``beta``: slow-momentum decay; ``alpha``: slow learning rate.

    Workers start from disagreeing replicas, so the slow momentum
    re-injects a beta-decayed echo of old disagreement after every gossip
    mix: the consensus error contracts at about ``max(lambda_2(W), beta)``
    and is non-zero even under dense gossip until the echo dies out."""

    beta: float = 0.8
    alpha: float = 1.0

    def __post_init__(self):
        if not 0.0 <= self.beta < 1.0:
            raise ValueError(f"beta must be in [0, 1), got {self.beta}")
        if self.alpha <= 0.0:
            raise ValueError(f"alpha must be positive, got {self.alpha}")


def slowmo_init(params: dict[str, torch.Tensor]) -> dict[str, dict[str, torch.Tensor]]:
    """Outer state: ``x``, an f32 copy of the parameters (never aliasing
    them), and a zero momentum ``u``."""
    x = {n: p.detach().to(torch.float32, copy=True) for n, p in params.items()}
    return {"x": x, "u": {n: torch.zeros_like(t) for n, t in x.items()}}


def _fma_(a, b: torch.Tensor, c: torch.Tensor, out: torch.Tensor) -> None:
    """``out = a * b + c`` rounded once to f32, a slice at a time
    (``out`` may be ``b`` or ``c``)."""
    o, bf, cf = out.view(-1), b.reshape(-1), c.reshape(-1)
    a = torch.tensor(a, dtype=torch.float32, device=out.device)
    for lo in range(0, o.numel(), _SLICE):
        hi = lo + _SLICE
        o[lo:hi] = fma_f32(a, bf[lo:hi], cf[lo:hi])


@torch.no_grad()
def slowmo_update_(cfg: SlowMoConfig, params: dict[str, torch.Tensor], state: dict) -> None:
    """One slow-momentum step on the mixed ``params``, in place: ``state``'s
    ``u`` and ``x`` advance and each parameter tensor is overwritten with
    ``x`` (cast to its dtype)."""
    for n, y in params.items():
        x, u = state["x"][n], state["u"][n]
        d = x - y.to(torch.float32)
        _fma_(cfg.beta, u, d, u)
        del d
        _fma_(-cfg.alpha, u, x, x)
        y.copy_(x)


def slowmo_update(cfg: SlowMoConfig, mixed: dict[str, torch.Tensor], state: dict) -> tuple[dict, dict]:
    """The reference's functional form: ``(new_params, new_state)``, the
    inputs untouched."""
    new = {k: {n: t.clone() for n, t in v.items()} for k, v in state.items()}
    params = {n: t.clone() for n, t in mixed.items()}
    slowmo_update_(cfg, params, new)
    return params, new
