"""Pipeline parallelism: GPipe microbatches over an axis (counterpart of
``consensusml_tpu/parallel/pipeline.py``).

Layers are stacked on a leading axis and split over the ``pp`` ranks of
an :class:`~.axis.Axis` (each holds ``L/P`` contiguous layers);
microbatches flow through the stages with one stage-to-stage hop a tick.
Tick ``t`` has stage ``s`` on microbatch ``m = t - s`` (valid when ``0 <=
m < M``), ``T = M + P - 1`` ticks in all; the bubble is ``(P - 1) / T``.

The reference differentiates its ``scan`` + ``ppermute`` and gets the
reverse pipeline from the transposed ``ppermute``. Here each hop is
:func:`.axis.ppermute`, an autograd function whose backward sends the
activation's gradient one stage back. Every rank must run the same hops
in its backward, in the same order, or the sends would not meet: a hop
whose output a rank never uses (stage 0 takes its microbatches, not the
hop's; the last tick's hop goes nowhere) would be pruned from that rank's
graph. So the outputs are tied to every hop (:class:`_Tie`: identity
forward, zero gradients to the hops backward), which puts all T hops in
every rank's graph, run from the last tick back, as the schedule's
dependencies order them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from consensusml_tpu_torch.parallel.axis import Axis, ppermute, reduce_from

__all__ = ["pipeline_apply", "pipeline_last_stage_mean"]


class _Tie(torch.autograd.Function):
    """``outs`` unchanged, with every hop's output as an input whose
    gradient is zero."""

    @staticmethod
    def forward(ctx, outs, *hops):
        ctx.shapes = [(h.shape, h.dtype, h.device) for h in hops]
        return outs.view_as(outs)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.shapes))


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   microbatches: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Run ``microbatches`` ``(M, B, ...)`` (the same on every stage)
    through the stage pipeline. ``stage_fn(stage_params, x) -> y`` applies
    THIS rank's slice of the layer stack; ``y`` must have ``x``'s shape
    (stages chain into each other).

    Returns ``(M, B, ...)`` outputs that are VALID ON THE LAST STAGE ONLY
    (the others hold their own stage's outputs): reduce a loss taken there
    with :func:`pipeline_last_stage_mean`."""
    p, s = axis.size, axis.index
    m = microbatches.shape[0]
    outs: list = [None] * m
    hops = []
    act = torch.zeros_like(microbatches[0])  # what a later stage takes before its first microbatch arrives
    for t in range(m + p - 1):
        # stage 0 ingests microbatch t; a later stage takes the hop's
        # activation (its microbatch t - s arrives exactly now)
        x_in = microbatches[min(t, m - 1)].to(act.dtype) if s == 0 else act
        y = stage_fn(stage_params, x_in)
        if y.shape != x_in.shape:
            raise ValueError(
                f"stage_fn must preserve the activation shape (got {tuple(y.shape)} from {tuple(x_in.shape)}) "
                "- stages chain into each other"
            )
        idx = t - s  # this stage's microbatch this tick (out of range: a bubble)
        if 0 <= idx < m:
            outs[idx] = y
        act = ppermute(y, axis, 1)
        hops.append(act)
    return _Tie.apply(torch.stack(outs), *hops)


def pipeline_last_stage_mean(value: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The LAST stage's ``value`` on every stage: the other stages' values
    masked to zero, then one all-reduce (backward: the gradient reaches
    the last stage's value only)."""
    last = torch.tensor(axis.index == axis.size - 1, device=value.device)
    return reduce_from(torch.where(last, value, torch.zeros_like(value)), axis)
