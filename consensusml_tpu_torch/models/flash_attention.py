"""Flash-attention forward: CUDA kernel + its plain PyTorch version.

Port of ``consensusml_tpu/models/flash_attention.py`` (forward only; the
backward kernels come with the training slice). The kernel is
``csrc/flash_attention_fwd.cu``; :func:`flash_attention_plain` computes
the same function — f32 logits, f32 softmax, f32 probabilities in the PV
product, output in ``dtype``, plus the per-row logsumexp — densely in
PyTorch. :func:`flash_attention` runs the plain version for tensors on the
CPU and the kernel for CUDA tensors (or raises); it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from consensusml_tpu_torch import kernels

__all__ = ["flash_attention", "flash_attention_plain"]

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
    (``m + log(max(l, 1e-30))``, as the reference saves it)."""
    _check_self_attention(q, k, v)
    b, s, h, d = q.shape
    scale = 1.0 / float(d) ** 0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
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
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    l_safe = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhst,bthd->bshd", p, v.float()) / l_safe.transpose(1, 2)
    out = out.to(dtype)
    if return_lse:
        return out, (m + torch.log(l_safe))[..., 0]
    return out


def _lib():
    lib = kernels.load("flash_attention_fwd")
    fn = lib.cml_flash_attention_fwd_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


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
    """Self-attention through the CUDA flash forward (the reference's
    ``flash_attention`` contract, layout ``(B, S, H, D)``).

    A CPU tensor runs :func:`flash_attention_plain`. A CUDA tensor
    launches ``csrc/flash_attention_fwd.cu`` on the current stream: bf16,
    contiguous, head dim 64; ``kv_mask`` is not in this kernel yet and
    raises ``NotImplementedError``. Each launch adds one to
    ``flash_attention.launches``.
    """
    if not q.is_cuda:
        return flash_attention_plain(
            q, k, v, causal=causal, kv_mask=kv_mask, dtype=dtype, return_lse=return_lse
        )
    _check_self_attention(q, k, v)
    if kv_mask is not None:
        raise NotImplementedError("the CUDA flash forward has no kv_mask yet")
    b, s, h, d = q.shape
    if d != _KERNEL_HEAD_DIM:
        raise NotImplementedError(f"the CUDA flash forward takes head dim 64, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device or t.data_ptr() % 4:
            raise ValueError(
                f"{name} must be a contiguous, 4-byte aligned bf16 tensor on {q.device}, "
                f"got {t.dtype} contiguous={t.is_contiguous()} on {t.device}"
            )
    if b * h > 65535:
        raise ValueError(f"batch * heads = {b * h} exceeds the grid's y limit 65535")
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
    out = out.to(dtype)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
