"""Flash attention, forward and backward: CUDA kernels + plain versions.

Port of ``consensusml_tpu/models/flash_attention.py``. Three kernels:

- ``csrc/flash_attention_fwd.cu`` (wrapper :func:`flash_attention`),
  replacing the reference's ``_fwd`` (``pallas_call`` at :193): the
  forward and its per-row logsumexp; plain version
  :func:`flash_attention_plain` (f32 logits, f32 softmax, f32
  probabilities in the PV product, output in ``dtype``);
- ``csrc/flash_attention_bwd.cu`` (wrappers :func:`flash_attention_bwd_dq`
  and :func:`flash_attention_bwd_dkv`), replacing ``_bwd_dq`` (:362) and
  ``_bwd_dkv`` (:400): the backward from the saved logsumexp; plain
  version :func:`flash_attention_bwd_plain` (dense recomputation, same f32
  math, outputs in the input dtype).

The three kernels are bound by operations: they run every product on
Hopper's tensor cores (``wgmma``, operands staged by TMA,
``csrc/flash_sm90.cuh``), bf16 operands into f32 accumulators. Their
accumulating products take an f32 tile (the forward's probabilities,
dq's ds, dk/dv's transposed probabilities and ds) as two bf16 halves,
``hi = bf16(x)`` and ``lo = bf16(x - hi)``: one bf16 rounding would miss
the card's gates against the plain versions, the forward's by 2.9-15x
(an f32 emulation of both roundings is in
``tests/test_torch_flash_attention.py``). TMA reads the operands, so
they must be 16-byte aligned.

Under autograd :func:`flash_attention` is a ``torch.autograd.Function``
(the reference's ``custom_vjp``): the forward saves ``q, k, v, o, lse``;
the backward computes ``delta = sum(do * o)`` in f32 with plain ops (the
reference does this outside its kernels too) and launches the dq and
dk/dv kernels. Every wrapper runs its plain version for tensors on the
CPU and its kernel for CUDA tensors (or raises); it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from consensusml_tpu_torch import kernels
from consensusml_tpu_torch.numerics import ftz

__all__ = [
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_bwd_plain",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv",
]

_NEG_INF = -1e30
_KERNEL_HEAD_DIM = 64


def _check_self_attention(q, k, v):
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention is self-attention-shaped: q{tuple(q.shape)} "
            f"k{tuple(k.shape)} v{tuple(v.shape)}"
        )


def flash_attention_plain(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,  # (B, S), >0 = attend to that key
    dtype: torch.dtype = torch.bfloat16,
    return_lse: bool = False,
):
    """The kernel's function in plain PyTorch. Returns ``out`` (B, S, H, D)
    in ``dtype``, and with ``return_lse`` also the logsumexp (B, H, S) f32
    (``m + log(max(l, 1e-30))``, as the reference saves it). The operands
    and each f32 result are flushed as the reference's compiled program
    flushes them (:func:`~consensusml_tpu_torch.numerics.ftz`)."""
    _check_self_attention(q, k, v)
    b, s, h, d = q.shape
    scale = 1.0 / float(d) ** 0.5
    logits = ftz(ftz(torch.einsum("bshd,bthd->bhst", ftz(q.float()), ftz(k.float()))) * scale)
    valid = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid.tril()
    valid = valid[None, None]
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, s):
            raise ValueError(f"kv_mask must be (batch, seq) = {(b, s)}, got {tuple(kv_mask.shape)}")
        valid = valid & (kv_mask > 0)[:, None, None, :]
    logits = torch.where(valid, logits, _NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.where(valid, ftz(torch.exp(ftz(logits - m))), 0.0)
    l_safe = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = ftz(ftz(torch.einsum("bhst,bthd->bshd", p, ftz(v.float()))) / l_safe.transpose(1, 2))
    out = out.to(dtype)
    if return_lse:
        return out, ftz(m + torch.log(l_safe))[..., 0]
    return out


def _lib():
    lib = kernels.load("flash_attention_fwd")
    fn = lib.cml_flash_attention_fwd_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def _bwd_lib(name: str, n_out: int):
    fn = getattr(kernels.load("flash_attention_bwd"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (6 + n_out) + [i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def _check_kernel_operands(q, tensors, align: int) -> None:
    b, s, h, d = q.shape
    if d != _KERNEL_HEAD_DIM:
        raise NotImplementedError(f"the CUDA flash kernels take head dim 64, got {d}")
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the grid's y limit 65535")
    for name, t in tensors:
        if (t.dtype != torch.bfloat16 or t.shape != q.shape or not t.is_contiguous()
                or t.device != q.device or t.data_ptr() % align):
            raise ValueError(
                f"{name} must be a contiguous, {align}-byte aligned bf16 tensor of shape "
                f"{tuple(q.shape)} on {q.device}, got {t.dtype} {tuple(t.shape)} "
                f"contiguous={t.is_contiguous()} on {t.device}"
            )


def _forward(q, k, v, causal: bool, return_lse: bool):
    """The forward kernel: ``(out (B, S, H, D) bf16, lse (B, H, S) f32 or
    None)`` (operands bf16, contiguous, 16-byte aligned, head dim 64). Each
    launch adds one to ``flash_attention.launches``."""
    _check_self_attention(q, k, v)
    _check_kernel_operands(q, (("q", q), ("k", k), ("v", v)), 16)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    rc = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, s, h, d, int(causal), 1.0 / float(d) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse


def _bwd_plain_parts(q, k, v, dout, lse, delta, causal: bool):
    """Dense recomputation of the backward from the saved logsumexp, f32
    math: ``(dq, dk, dv)`` in q's dtype, the operands and each f32 result
    flushed as :func:`flash_attention_plain` flushes them."""
    _check_self_attention(q, k, v)
    s = q.shape[1]
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    qf, kf, vf, dof = (ftz(t.float()) for t in (q, k, v, dout))
    logits = ftz(ftz(torch.einsum("bshd,bthd->bhst", qf, kf)) * scale)
    valid = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid.tril()
    p = torch.where(valid, ftz(torch.exp(ftz(logits - lse[..., None]))), 0.0)
    del logits
    dp = ftz(torch.einsum("bshd,bthd->bhst", dof, vf))
    ds = ftz(p * ftz(dp - delta[..., None]))
    del dp
    dq = ftz(ftz(torch.einsum("bhst,bthd->bshd", ds, kf)) * scale)
    dk = ftz(ftz(torch.einsum("bhst,bshd->bthd", ds, qf)) * scale)
    dv = ftz(torch.einsum("bhst,bshd->bthd", p, dof))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``sum(do * o)`` per query row in f32, laid out (B, H, S): a subnormal
    ``do`` read as 0 (``o`` is never subnormal: both forwards flush it), the
    sum flushed (a subnormal product among normal ones moves it by less
    than an ulp, so the products are not: these plain ops run on the
    card's training path too)."""
    return ftz((ftz(dout.float()) * out.float()).sum(-1)).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal: bool = False):
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv)`` of
    self-attention with output ``out`` and its logsumexp ``lse`` (B, H, S),
    for the output cotangent ``dout`` — the reference's ``_bwd`` (delta,
    then the dq and dk/dv recomputations) op for op, densely."""
    return _bwd_plain_parts(q, k, v, dout, lse, _delta(out, dout), causal)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = False):
    """dq through ``csrc/flash_attention_bwd.cu`` for CUDA tensors (bf16,
    contiguous, 16-byte aligned, head dim 64; ``lse``/``delta`` (B, H, S)
    f32), the plain version for CPU tensors. Each launch adds one to
    ``flash_attention_bwd_dq.launches``."""
    if not q.is_cuda:
        return _bwd_plain_parts(q, k, v, dout, lse, delta, causal)[0]
    ops = (("q", q), ("k", k), ("v", v), ("dout", dout))
    _check_kernel_operands(q, ops, 16)
    _check_row_stats(q, lse, delta)
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    rc = _bwd_lib("cml_flash_attention_bwd_dq_bf16", 1)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, s, h, d, int(causal), 1.0 / float(d) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA error {rc}")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = False):
    """``(dk, dv)`` through ``csrc/flash_attention_bwd.cu`` for CUDA
    tensors, the plain version for CPU tensors (same operand rules as
    :func:`flash_attention_bwd_dq`). Each launch adds one to
    ``flash_attention_bwd_dkv.launches``."""
    if not q.is_cuda:
        return _bwd_plain_parts(q, k, v, dout, lse, delta, causal)[1:]
    ops = (("q", q), ("k", k), ("v", v), ("dout", dout))
    _check_kernel_operands(q, ops, 16)
    _check_row_stats(q, lse, delta)
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _bwd_lib("cml_flash_attention_bwd_dkv_bf16", 2)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d, int(causal),
        1.0 / float(d) ** 0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA error {rc}")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _check_row_stats(q, lse, delta) -> None:
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s) or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous (B, H, S) = {(b, h, s)} f32 tensor on {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` around the flash forward: saves
    ``q, k, v, o, lse``; the backward is the dq and dk/dv wrappers (the
    kernels for CUDA tensors, their plain version for CPU ones)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda:
            out, lse = _forward(q, k, v, causal, True)
        else:
            out, lse = flash_attention_plain(q, k, v, causal=causal, dtype=q.dtype, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = _delta(out, dout)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,
    dtype: torch.dtype = torch.bfloat16,
    return_lse: bool = False,
):
    """Self-attention through the CUDA flash kernels (the reference's
    ``flash_attention`` contract, layout ``(B, S, H, D)``).

    A CPU tensor runs the plain versions. A CUDA tensor launches
    ``csrc/flash_attention_fwd.cu`` on the current stream (bf16,
    contiguous, 16-byte aligned, head dim 64) and, when autograd records
    the call, the backward kernels of ``csrc/flash_attention_bwd.cu``.
    ``kv_mask`` is not in these kernels yet and raises
    ``NotImplementedError`` on the card.
    """
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if kv_mask is not None and (q.is_cuda or needs_grad):
        raise NotImplementedError("the flash kernels and their autograd path have no kv_mask yet")
    if needs_grad:
        out, lse = _FlashAttention.apply(q, k, v, causal)
        out = out.to(dtype)
        return (out, lse) if return_lse else out
    if not q.is_cuda:
        return flash_attention_plain(
            q, k, v, causal=causal, kv_mask=kv_mask, dtype=dtype, return_lse=return_lse
        )
    out, lse = _forward(q, k, v, causal, return_lse)
    out = out.to(dtype)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
