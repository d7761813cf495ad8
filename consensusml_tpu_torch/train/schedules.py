"""Learning-rate schedules and the optimizer rebuild of the train CLI (port
of ``consensusml_tpu/train/schedules.py``).

Schedules count OPTIMIZER STEPS: one gossip round runs ``h`` local steps,
so the CLI converts ``--warmup-rounds`` and ``--rounds`` to steps first.
The count lives in the optimizer state (``sched_count``, int32 per
worker, as optax's ``ScaleByScheduleState``), which is checkpointed, so
``--resume`` continues the schedule where it stopped.

The reference's schedules are optax's ``linear_schedule``,
``warmup_cosine_decay_schedule`` and ``join_schedules``, evaluated inside
the compiled train step at one int32 count. Their values here are those
of the program XLA compiles for that scalar, op for op in float32
(``jax.jit(schedule).lower(jnp.int32(0)).compile().as_text()``):

- a linear piece from ``a`` to ``b`` over ``n`` steps is
  ``fma(fma(-c, f32(1/n), 1), f32(a - b), f32(b))`` with ``c`` the count
  clipped to ``[0, n]`` (XLA turns ``c / n`` into a product with the
  reciprocal and contracts both multiply-adds);
- the cosine decay over ``d`` steps is ``(cosf(min(f32(c), d) * f32(f32(pi)
  * f32(1/d))) + 1) * f32(peak / 2)``, with ``cosf`` the C library's float
  cosine, which XLA's CPU code calls (XLA folds ``pi * c / d`` into a
  product with one constant, itself the product of ``pi`` and ``1/d``);
- ``join_schedules`` selects the piece by ``count < boundary`` and feeds
  the later piece ``count - boundary``.

Every value of the three kinds, with and without warmup, equals the
compiled reference's bit for bit (``tests/test_torch_schedules.py``).
A host whose C library has no ``cosf`` cannot build a cosine schedule:
the correctly rounded cosine differs from glibc's in the last bit at
some arguments.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import inspect
from typing import Callable, Union

import numpy as np

__all__ = ["Schedule", "lr_schedule", "build_optimizer", "KINDS"]

KINDS = ("constant", "cosine", "linear")
_f32 = np.float32


@functools.lru_cache(maxsize=1)
def _cosf():
    """The C library's single-precision cosine."""
    name = ctypes.util.find_library("m")
    if name is None:
        raise OSError("the C math library (libm) was not found: the cosine schedule needs its cosf")
    fn = ctypes.CDLL(name).cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lambda x: _f32(fn(float(x)))


def _fma(a, b, c) -> np.float32:
    """``a * b + c`` with one rounding to f32 (the f64 product of two f32
    values is exact)."""
    return _f32(np.float64(a) * np.float64(b) + np.float64(c))


def _linear(count: int, init: float, end: float, steps: int) -> np.float32:
    """optax's ``linear_schedule(init, end, steps)`` at ``count``."""
    if steps <= 0:
        return _f32(init)
    c = _f32(min(max(count, 0), steps))
    frac = _fma(-c, _f32(_f32(1.0) / _f32(steps)), _f32(1.0))
    return _fma(frac, _f32(init - end), _f32(end))


def _cosine(count: int, peak: float, steps: int) -> np.float32:
    """optax's ``cosine_decay_schedule(peak, steps)`` (alpha 0) at ``count``."""
    x = min(_f32(count), _f32(steps))
    arg = _f32(x * _f32(_f32(np.pi) * _f32(_f32(1.0) / _f32(steps))))
    return _f32(_f32(_cosf()(arg) + _f32(1.0)) * _f32(0.5 * peak))


@dataclasses.dataclass(frozen=True)
class Schedule:
    """``kind`` with ``warmup_steps`` of linear warmup from 0 to ``peak``,
    then constant, cosine decay to 0 at ``total_steps``, or linear decay
    to 0 at ``total_steps``. Called with an int step count, returns the
    learning rate as a Python float holding an f32 value."""

    kind: str
    peak: float
    total_steps: int
    warmup_steps: int

    def value(self, count: int) -> np.float32:
        w = self.warmup_steps
        if self.kind == "constant":
            return _linear(count, 0.0, self.peak, w) if count < w else _f32(self.peak)
        if self.kind == "cosine":
            if count < w:
                return _linear(count, 0.0, self.peak, w)
            return _cosine(count - w, self.peak, self.total_steps - w)
        if count < w:
            return _linear(count, 0.0, self.peak, max(w, 1))
        return _linear(count - w, self.peak, 0.0, self.total_steps - w)

    def __call__(self, count: int) -> float:
        return float(self.value(int(count)))


ScheduleOrFloat = Union[float, Schedule]


def lr_schedule(kind: str, peak: float, total_steps: int, warmup_steps: int = 0) -> ScheduleOrFloat:
    """``constant`` | ``cosine`` | ``linear`` with ``warmup_steps`` of
    linear warmup from 0, with the reference's checks. Returns the plain
    float ``peak`` when there is nothing to schedule, so the optimizer
    state stays schedule-free."""
    if kind in ("cosine", "linear") and total_steps <= 0:
        raise ValueError(f"kind={kind!r} decays over the horizon and needs total_steps > 0 (got {total_steps})")
    # a pure-warmup constant schedule needs no horizon; the decaying kinds
    # (checked above to have one) must finish warming up first
    if warmup_steps > 0 and total_steps > 0 and warmup_steps >= total_steps:
        raise ValueError(f"warmup ({warmup_steps} steps) must be shorter than the schedule ({total_steps} steps)")
    if kind not in KINDS:
        raise ValueError(f"unknown lr schedule {kind!r}")
    if kind == "constant" and warmup_steps <= 0:
        return peak
    return Schedule(kind, float(peak), int(total_steps), int(warmup_steps))


def _accepts_clip(factory: Callable) -> bool:
    try:
        sig = inspect.signature(factory)
    except (TypeError, ValueError):  # callables without a signature
        return False
    return "grad_clip" in sig.parameters or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
    )


def build_optimizer(factory: Callable, *, peak_lr: float, kind: str = "constant", total_steps: int = 0,
                    warmup_steps: int = 0, grad_clip: float = 0.0):
    """A config's optimizer rebuilt with a schedule and optional global-norm
    clipping, the clip before the optimizer. A factory that accepts
    ``grad_clip`` places the clip itself (LoRA's: the norm covers the
    trained adapters, not the frozen base); a plain one gets
    :func:`~consensusml_tpu_torch.train.optim.clip_by_global_norm` in front.
    Support is read off the signature, never by catching ``TypeError``: a
    ``TypeError`` inside a clip-aware factory must propagate."""
    from consensusml_tpu_torch.train.optim import clip_by_global_norm

    sched = lr_schedule(kind, peak_lr, total_steps, warmup_steps)
    if _accepts_clip(factory):
        return factory(sched, grad_clip=grad_clip)
    tx = factory(sched)
    return clip_by_global_norm(grad_clip, tx) if grad_clip > 0 else tx
