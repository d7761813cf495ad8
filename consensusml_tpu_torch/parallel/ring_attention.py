"""Ring attention: exact attention over a sequence split along an axis
(counterpart of ``consensusml_tpu/parallel/ring_attention.py``).

Each rank of a sequence-parallel :class:`~.axis.Axis` holds one block of
the sequence, ``(B, S_blk, H, D)`` of Q, K and V, rank ``i`` the
positions ``i * S_blk ..``. The K/V blocks travel round the ring (rank
``i`` sends to ``i + 1``, receives from ``i - 1``: the port's transport,
route ``(i + 1, i - 1)``) while every rank folds its queries' attention
to each visiting block into an online softmax. After P steps each query
has attended to the whole sequence with only one block of K/V resident.

- :func:`ring_attention`: the dense form, f32 logits and running max and
  sum, as the reference's (differentiable through :func:`.axis.ppermute`);
- :func:`ring_flash_attention`: each (local Q x visiting K/V) tile runs the
  flash kernels' offset form (``q_offset = i * S_blk``, ``k_offset = src *
  S_blk``), the partial outputs merged by their logsumexp; its backward
  is a second ring in which each block's dk/dv travels with it and lands
  back home. Under ``causal`` a block that comes after every query of this
  rank (``src > i``) is skipped: the kernel's answer for it (rows that
  attend to no key: lse -1e30) is weighed ``exp(-1e30 - m) = 0`` by the
  merge and its gradients are 0, so skipping it leaves every number as
  it was; the block still travels on.

The per-rank block need not be a multiple of the kernels' 64-row tile:
they take a ragged length and mask its tail (the reference pads to its
512-row block instead).
"""

from __future__ import annotations

import math

import torch

from consensusml_tpu_torch.parallel.axis import Axis, ppermute

__all__ = ["ring_attention", "ring_flash_attention"]

_NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis: Axis, *,
                   causal: bool = False) -> torch.Tensor:
    """Exact attention across the whole (split) sequence: this rank's
    output block ``(B, S_blk, H, D)`` in ``q.dtype``. Causal masking uses
    absolute positions from the rank's index, so the result is
    single-device causal attention on the gathered sequence."""
    p, my = axis.size, axis.index
    b, s_blk, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    pos_q = my * s_blk + torch.arange(s_blk, device=q.device)
    out = torch.zeros((b, s_blk, h, d), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, h, s_blk), _NEG_INF, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, h, s_blk), dtype=torch.float32, device=q.device)
    k_t, v_t = k, v
    for t in range(p):
        src = (my - t) % p  # the block held after t rotations came from rank my - t
        logits = torch.einsum("bshd,bthd->bhst", q.float(), k_t.float()) * scale
        if causal:
            pos_k = src * s_blk + torch.arange(s_blk, device=q.device)
            logits = torch.where((pos_q[:, None] >= pos_k[None, :])[None, None], logits, _NEG_INF)
        new_max = torch.maximum(row_max, logits.amax(-1))
        correction = torch.exp(row_max - new_max)
        probs = torch.exp(logits - new_max[..., None])
        row_sum = row_sum * correction + probs.sum(-1)
        out = out * correction.transpose(1, 2)[..., None] + torch.einsum("bhst,bthd->bshd", probs, v_t.float())
        row_max = new_max
        if t + 1 < p:  # the last rotation would only bring the blocks home
            k_t, v_t = ppermute(k_t, axis), ppermute(v_t, axis)
    denom = torch.clamp(row_sum, min=1e-30).transpose(1, 2)[..., None]
    return (out / denom).to(q.dtype)


def _skipped(causal: bool, src: int, my: int) -> bool:
    """A block after every local query: no pair is attended."""
    return causal and src > my


def _rotate(tensors: list[torch.Tensor], axis: Axis) -> list[torch.Tensor]:
    """Each tensor sent one rank on round the ring; the neighbour's back."""
    if axis.size == 1:
        return tensors
    return axis.transport.exchange([t.contiguous() for t in tensors], [axis.route(1)])[0]


class _RingFlash(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_ring_flash``: forward and backward
    rings over the flash wrappers (kernels for CUDA tensors, their plain
    versions for CPU ones)."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal):
        from consensusml_tpu_torch.models.flash_attention import flash_attention

        p, my = axis.size, axis.index
        b, s_blk, h, d = q.shape
        acc = torch.zeros((b, s_blk, h, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, s_blk), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, s_blk), dtype=torch.float32, device=q.device)  # noqa: E741
        k_t, v_t = k, v
        for t in range(p):
            src = (my - t) % p
            if not _skipped(causal, src, my):
                o_t, lse_t = flash_attention(q, k_t, v_t, causal=causal, dtype=q.dtype, return_lse=True,
                                             q_offset=my * s_blk, k_offset=src * s_blk)
                m_new = torch.maximum(m, lse_t)
                c_old, c_new = torch.exp(m - m_new), torch.exp(lse_t - m_new)
                acc = acc * c_old.transpose(1, 2)[..., None] + o_t.float() * c_new.transpose(1, 2)[..., None]
                l = l * c_old + c_new  # noqa: E741
                m = m_new
            if t + 1 < p:
                k_t, v_t = _rotate([k_t, v_t], axis)
        l_safe = torch.clamp(l, min=1e-30)
        out = (acc / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
        lse = (m + torch.log(l_safe)).contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal = axis, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        from consensusml_tpu_torch.models.flash_attention import (
            _delta,
            flash_attention_bwd_dkv,
            flash_attention_bwd_dq,
        )

        q, k, v, out, lse = ctx.saved_tensors
        axis, causal = ctx.axis, ctx.causal
        p, my = axis.size, axis.index
        s_blk = q.shape[1]
        do = dout.to(q.dtype).contiguous()
        delta = _delta(out, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_t = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv_t = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_t, v_t = k, v
        for t in range(p):
            src = (my - t) % p
            if not _skipped(causal, src, my):
                off = {"causal": causal, "q_offset": my * s_blk, "k_offset": src * s_blk}
                dq = dq + flash_attention_bwd_dq(q, k_t, v_t, do, lse, delta, **off).float()
                dk_c, dv_c = flash_attention_bwd_dkv(q, k_t, v_t, do, lse, delta, **off)
                dk_t, dv_t = dk_t + dk_c.float(), dv_t + dv_c.float()
            # the block's gradient travels with it: after P hops it is home
            if t + 1 < p:
                k_t, v_t, dk_t, dv_t = _rotate([k_t, v_t, dk_t, dv_t], axis)
            else:
                dk_t, dv_t = _rotate([dk_t, dv_t], axis)
        return dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype), None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis: Axis, *,
                         causal: bool = False) -> torch.Tensor:
    """Ring attention whose per-step tiles run the flash kernels' q/k
    offset form (module docstring); same contract as
    :func:`ring_attention`. Differentiable: its backward is the second
    ring."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"ring_flash_attention needs equal block shapes: q{tuple(q.shape)} k{tuple(k.shape)}")
    return _RingFlash.apply(q, k, v, axis, causal)
