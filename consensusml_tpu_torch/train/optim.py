"""Adam and SGD with optax's exact updates, as plain tensor ops.

The reference trains with ``optax.adam`` and ``optax.sgd`` (a library, so
there is no JAX module to mirror). ``torch.optim.Adam`` is a different optimiser in the
last bits: it adds ``eps`` after dividing the square root by the bias
correction and may run fused multi-tensor paths. This module is optax's
``scale_by_adam`` followed by ``scale_by_learning_rate``, op for op:

    mu    = (1 - b1) * g + b1 * mu
    nu    = (1 - b2) * g**2 + b2 * nu
    count = count + 1                       (int32, saturating)
    u     = (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)
    p     = p + (-lr) * u

with the bias corrections computed in float32 from the integer count.
:class:`SGD` is ``optax.sgd(lr, momentum)``: ``trace`` then
``scale_by_learning_rate``, op for op:

    t = g + momentum * t
    p = p + (-lr) * t

``lr`` is a float or a schedule of the step count
(:class:`~consensusml_tpu_torch.train.schedules.Schedule`): then the
state carries the schedule's own int32 count per worker, ``sched_count``
(optax's ``ScaleByScheduleState``), read before the step and incremented
after it, saturating.

:func:`clip_by_global_norm` is optax's ``clip_by_global_norm`` chained in
front of another optimizer: the norm is ``sqrt`` of the sum, leaf by leaf
in the parameters' flatten order, of each gradient's sum of squares, and
each gradient becomes ``where(norm < max, g, g / norm * max)``. Its state
(:class:`ClipState`) holds the inner optimizer's and each worker's latest
pre-clip norm (what the trainer reports; optax keeps none).

State is stacked over workers (leading axis). Every optimizer has
``init(params, world_size)``, ``update_(params, grads, state, worker)``,
which updates one worker's views in place, and ``trains(name)``, whether
it updates the leaf ``name`` at all (a trainer takes gradients only of
those). :func:`lora_optimizer` is the reference's ``lora_optimizer``
(``optax.multi_transform`` of an inner optimizer on the adapters and
``set_to_zero`` on the rest): the inner optimizer's state and updates
cover the adapter leaves only, and a frozen leaf is never written; its
``grad_clip`` clips inside that mask, over the adapters' norm."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = [
    "Adam", "AdamState", "adam", "SGD", "SGDState", "sgd", "LoRAOptimizer", "lora_optimizer",
    "ClipByGlobalNorm", "ClipState", "clip_by_global_norm", "clip_norms", "latest_lr",
]

_INT32_MAX = np.iinfo(np.int32).max


def _sched_init(lr, world_size: int) -> torch.Tensor | None:
    return torch.zeros((world_size,), dtype=torch.int32) if callable(lr) else None


def _step_lr(lr, sched_count: torch.Tensor | None, worker: int) -> float:
    """The learning rate of worker ``worker``'s step: ``lr`` itself, or the
    schedule at the worker's count, which then advances (saturating, as
    optax's ``safe_increment``)."""
    if sched_count is None:
        return lr
    count = int(sched_count[worker])
    sched_count[worker] = min(count + 1, _INT32_MAX)
    return lr(count)


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # (W,) int32 on the host: steps taken per worker
    mu: dict[str, torch.Tensor]  # stacked (W, ...) f32, like params
    nu: dict[str, torch.Tensor]
    sched_count: torch.Tensor | None = None  # (W,) int32 on the host, with a schedule


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: Any  # float, or a schedule of the step count
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict[str, torch.Tensor], world_size: int) -> AdamState:
        return AdamState(
            count=torch.zeros((world_size,), dtype=torch.int32),
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
            sched_count=_sched_init(self.lr, world_size),
        )

    def trains(self, name: str) -> bool:
        return True

    def _correction(self, decay: float, count: int, device) -> torch.Tensor:
        # optax: 1 - decay**count in float32, divided by as a tensor (a
        # Python-scalar divisor may become a reciprocal product)
        d = np.float32(decay) ** np.float32(count)
        return torch.tensor(np.float32(1.0) - d, dtype=torch.float32, device=device)

    @torch.no_grad()
    def update_(self, params: dict, grads: dict, state: AdamState, worker: int) -> None:
        """One step of worker ``worker``: ``params[n]`` are that worker's
        (views of the stacked) f32 parameters, updated in place with the
        moments ``state.mu[n][worker]`` / ``state.nu[n][worker]``."""
        count = min(int(state.count[worker]) + 1, _INT32_MAX)
        state.count[worker] = count
        lr = _step_lr(self.lr, state.sched_count, worker)
        bc1 = bc2 = None
        for name, p in params.items():
            g = grads[name]
            if bc1 is None:
                bc1 = self._correction(self.b1, count, p.device)
                bc2 = self._correction(self.b2, count, p.device)
            mu = state.mu[name][worker]
            nu = state.nu[name][worker]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.copy_(p + (-lr) * u)


def adam(lr) -> Adam:
    """``optax.adam(lr)`` with optax's defaults; ``lr`` a float or a schedule."""
    return Adam(lr=lr)


@dataclasses.dataclass
class SGDState:
    trace: dict[str, torch.Tensor]  # stacked (W, ...) f32 momentum
    sched_count: torch.Tensor | None = None  # (W,) int32 on the host, with a schedule


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Any  # float, or a schedule of the step count
    momentum: float

    def init(self, params: dict[str, torch.Tensor], world_size: int) -> SGDState:
        return SGDState(trace={n: torch.zeros_like(p) for n, p in params.items()},
                        sched_count=_sched_init(self.lr, world_size))

    def trains(self, name: str) -> bool:
        return True

    @torch.no_grad()
    def update_(self, params: dict, grads: dict, state: SGDState, worker: int) -> None:
        """One step of worker ``worker`` on its (views of the stacked)
        params, in place. Multi-tensor ops, each rounding once as the
        separate optax ops do: ``t * momentum``, ``+ g``, ``* (-lr)``,
        ``p +``."""
        lr = _step_lr(self.lr, state.sched_count, worker)
        names = list(params)
        t = [state.trace[n][worker] for n in names]
        torch._foreach_mul_(t, self.momentum)
        torch._foreach_add_(t, [grads[n] for n in names])
        torch._foreach_add_([params[n] for n in names], torch._foreach_mul(t, -lr))


def sgd(lr, momentum: float) -> SGD:
    """``optax.sgd(lr, momentum)`` (no Nesterov); ``lr`` a float or a schedule."""
    return SGD(lr=lr, momentum=momentum)


@dataclasses.dataclass
class ClipState:
    norm: torch.Tensor  # (W,) f32: each worker's latest pre-clip global norm
    inner: Any  # the inner optimizer's state


@dataclasses.dataclass(frozen=True)
class ClipByGlobalNorm:
    """``optax.chain(optax.clip_by_global_norm(max_norm), inner)``."""

    max_norm: float
    inner: Any

    @property
    def lr(self):
        return self.inner.lr

    def trains(self, name: str) -> bool:
        return self.inner.trains(name)

    def init(self, params: dict[str, torch.Tensor], world_size: int) -> ClipState:
        device = next(iter(params.values())).device if params else None
        return ClipState(norm=torch.zeros((world_size,), dtype=torch.float32, device=device),
                         inner=self.inner.init(params, world_size))

    @torch.no_grad()
    def update_(self, params: dict, grads: dict, state: ClipState, worker: int) -> None:
        """Clip worker ``worker``'s gradients of the leaves ``params`` holds
        (in their order, the flatten order) by their global norm, then step
        the inner optimizer. Nothing is read back to the host."""
        names = list(params)
        norm = None
        for n in names:
            sq = torch.sum(grads[n] * grads[n])
            norm = sq if norm is None else norm + sq
        norm = torch.sqrt(norm)
        state.norm[worker] = norm
        keep = norm < self.max_norm
        clipped = {n: torch.where(keep, grads[n], (grads[n] / norm) * self.max_norm) for n in names}
        self.inner.update_(params, clipped, state.inner, worker)


def clip_by_global_norm(max_norm: float, inner) -> ClipByGlobalNorm:
    """``inner`` behind global-norm clipping at ``max_norm``."""
    return ClipByGlobalNorm(float(max_norm), inner)


@dataclasses.dataclass(frozen=True)
class LoRAOptimizer:
    """``inner`` on the LoRA adapter leaves, nothing on the rest (the
    reference's ``multi_transform({"lora": inner, "frozen":
    set_to_zero()})``: a zero update leaves a frozen leaf's value as it
    is, so here it is not written at all). ``init`` and ``update_`` take
    the whole parameter dict, frozen leaves included or not; ``grads``
    need hold only the adapters."""

    inner: Any

    @property
    def lr(self):
        return self.inner.lr

    def trains(self, name: str) -> bool:
        from consensusml_tpu_torch.models.lora import is_lora_path

        return is_lora_path((name,))

    def init(self, params: dict[str, torch.Tensor], world_size: int):
        return self.inner.init({n: p for n, p in params.items() if self.trains(n)}, world_size)

    def update_(self, params: dict, grads: dict, state, worker: int) -> None:
        names = [n for n in params if self.trains(n)]
        self.inner.update_({n: params[n] for n in names}, {n: grads[n] for n in names}, state, worker)


def lora_optimizer(inner, grad_clip: float = 0.0) -> LoRAOptimizer:
    """The reference's ``lora_optimizer(inner)``: ``inner`` updates only the
    adapter leaves; the base stays frozen. ``grad_clip > 0`` clips inside
    the mask, by the adapters' global norm (the frozen base's gradients,
    which the reference discards, never enter it), as the reference's
    ``llama_lora`` factory chains the clip in front of ``inner``."""
    return LoRAOptimizer(clip_by_global_norm(grad_clip, inner) if grad_clip > 0 else inner)


def _unwrap(optimizer, state):
    """``(base optimizer, its state, the clip's state or None)``."""
    clip = None
    while True:
        if isinstance(optimizer, LoRAOptimizer):
            optimizer = optimizer.inner
        elif isinstance(optimizer, ClipByGlobalNorm):
            clip, optimizer, state = state, optimizer.inner, state.inner
        else:
            return optimizer, state, clip


def clip_norms(optimizer, state) -> torch.Tensor | None:
    """Each worker's pre-clip global norm at its latest step, ``(W,)`` on
    the device, or None without clipping."""
    clip = _unwrap(optimizer, state)[2]
    return None if clip is None else clip.norm


def latest_lr(optimizer, state, worker: int = 0) -> float:
    """The learning rate of worker ``worker``'s latest step (of its first
    step before it took any)."""
    base, st, _ = _unwrap(optimizer, state)
    if not callable(base.lr):
        return float(base.lr)
    return base.lr(max(int(st.sched_count[worker]) - 1, 0))
