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

Each kernel has a no-mask form and a ``kv_mask`` form (the per-key
padding mask, BERT's ``attention_mask``: one f32 row a batch, shared by
the heads), chosen by whether the caller passes a mask; a row that
attends to no key gets what the reference's kernel gives it
(:func:`flash_attention_plain`). Each form takes head dim 64 (GPT-2's,
BERT's) or 128 (Llama-2-7B's); the reference takes any, and the
wrappers refuse any other (``NotImplementedError``).

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
_KERNEL_HEAD_DIMS = (64, 128)
# the reference kernel's key and query block (_BK = _BQ = 512): the keys a
# row visits, and so what a row that attends to nothing gets, depend on it
_REF_BLOCK = 512


def _check_self_attention(q, k, v):
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention is self-attention-shaped: q{tuple(q.shape)} "
            f"k{tuple(k.shape)} v{tuple(v.shape)}"
        )


def _ref_visited_keys(s: int, causal: bool, device) -> torch.Tensor:
    """``(s,)`` int64: how many keys the reference's kernel visits for each
    query row, padding past ``s`` included. It pads the sequence to whole
    ``_REF_BLOCK``-key blocks and walks them all, or, causal, the blocks up
    to and including the row's own (its ``nk_eff``, ``flash_attention.py:
    127-131``): ``ceil(s / 512) * 512`` keys for every row, or ``512 *
    (row // 512 + 1)`` for row ``row`` under ``causal``."""
    rows = torch.arange(s, device=device)
    if causal:
        return _REF_BLOCK * (rows // _REF_BLOCK + 1)
    return torch.full((s,), -(-s // _REF_BLOCK) * _REF_BLOCK, device=device)


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
    """The kernel's function in plain PyTorch: what the reference's flash
    kernel computes for every row. Returns ``out`` (B, S, H, D) in
    ``dtype``, and with ``return_lse`` also the logsumexp (B, H, S) f32
    (``m + log(max(l, 1e-30))``, as the reference saves it). The operands
    and each f32 result are flushed as the reference's compiled program
    flushes them (:func:`~consensusml_tpu_torch.numerics.ftz`).

    As in the reference, a key that is masked (``kv_mask``), above the
    diagonal (``causal``) or padding scores ``-1e30``, not ``-inf``, over
    the keys its online softmax visits (:func:`_ref_visited_keys`); keys
    past those (the causal block skip) take no part. A row with at least
    one key to attend to therefore gets the softmax over those keys. A row
    that attends to no key (every key of its causal window masked) keeps
    its running max at ``-1e30``, so every visited key, padding included,
    gets ``p = exp(0) = 1``: ``out = sum_{visited t < S} v_t / n``, with
    ``n`` the visited count (``ceil(S / 512) * 512``, or ``512 * (row //
    512 + 1)`` under ``causal``: padding keys are zero vectors that count
    in ``n``), and ``lse = -1e30 + log(n) = -1e30`` in f32. The reference's
    backward gives such a row no gradient (:func:`flash_attention_bwd_plain`)."""
    _check_self_attention(q, k, v)
    b, s, h, d = q.shape
    scale = 1.0 / float(d) ** 0.5
    logits = ftz(ftz(torch.einsum("bshd,bthd->bhst", ftz(q.float()), ftz(k.float()))) * scale)
    visited_n = _ref_visited_keys(s, causal, q.device)
    valid = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid.tril()
    valid = valid[None, None]
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, s):
            raise ValueError(f"kv_mask must be (batch, seq) = {(b, s)}, got {tuple(kv_mask.shape)}")
        valid = valid & (kv_mask > 0)[:, None, None, :]
    logits = torch.where(valid, logits, _NEG_INF)
    if causal:  # keys past the row's last visited block take no part
        visited = torch.arange(s, device=q.device)[None, :] < visited_n[:, None]
        logits = torch.where(visited[None, None], logits, -torch.inf)
    m = logits.amax(-1, keepdim=True)
    p = ftz(torch.exp(ftz(logits - m)))
    # a row that attends to nothing: p = 1 at each of its visited keys, the
    # padding past S (zero vectors) counted too
    empty = m == _NEG_INF
    l_safe = torch.clamp(torch.where(empty, visited_n[:, None].float(), p.sum(-1, keepdim=True)), min=1e-30)
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
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def _bwd_lib(name: str, n_out: int):
    fn = getattr(kernels.load("flash_attention_bwd"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * (7 + n_out) + [i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def _check_kernel_operands(q, tensors, align: int) -> None:
    b, s, h, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"the CUDA flash kernels take head dim 64 or 128, got {d}")
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


def _check_kv_mask(q, kv_mask) -> None:
    """The kernels read ``kv_mask`` as one contiguous f32 row of S keys a
    batch, shared by the heads (>0 = attend)."""
    b, s = q.shape[:2]
    if kv_mask is None:
        return
    if (kv_mask.dtype != torch.float32 or tuple(kv_mask.shape) != (b, s) or not kv_mask.is_contiguous()
            or kv_mask.device != q.device):
        raise ValueError(
            f"kv_mask must be a contiguous (batch, seq) = {(b, s)} f32 tensor on {q.device}, "
            f"got {kv_mask.dtype} {tuple(kv_mask.shape)} on {kv_mask.device}"
        )


def _mask_ptr(kv_mask):
    return kv_mask.data_ptr() if kv_mask is not None else None


def _forward(q, k, v, causal: bool, return_lse: bool, kv_mask=None):
    """The forward kernel: ``(out (B, S, H, D) bf16, lse (B, H, S) f32 or
    None)`` (operands bf16, contiguous, 16-byte aligned, head dim 64 or
    128; ``kv_mask`` None or (B, S) f32, >0 = attend). Each launch adds one
    to ``flash_attention.launches``, a masked one also to
    ``flash_attention.masked_launches`` and one at head dim 128 to
    ``flash_attention.d128_launches``."""
    _check_self_attention(q, k, v)
    _check_kernel_operands(q, (("q", q), ("k", k), ("v", v)), 16)
    _check_kv_mask(q, kv_mask)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    rc = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(kv_mask), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, s, h, d, int(causal), 1.0 / float(d) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.masked_launches += kv_mask is not None
    flash_attention.d128_launches += d == 128
    return out, lse


def _bwd_plain_parts(q, k, v, dout, lse, delta, causal: bool, kv_mask=None):
    """Dense recomputation of the backward from the saved logsumexp, f32
    math: ``(dq, dk, dv)`` in q's dtype, the operands and each f32 result
    flushed as :func:`flash_attention_plain` flushes them. ``p = 0`` at
    every key the row does not attend to (causal, ``kv_mask``), as in the
    reference (``flash_attention.py:257-260, 313-316``): a row that attends
    to nothing gets no gradient."""
    _check_self_attention(q, k, v)
    b, s = q.shape[:2]
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    qf, kf, vf, dof = (ftz(t.float()) for t in (q, k, v, dout))
    logits = ftz(ftz(torch.einsum("bshd,bthd->bhst", qf, kf)) * scale)
    valid = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid.tril()
    valid = valid[None, None]
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, s):
            raise ValueError(f"kv_mask must be (batch, seq) = {(b, s)}, got {tuple(kv_mask.shape)}")
        valid = valid & (kv_mask > 0)[:, None, None, :]
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


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *, causal: bool = False, kv_mask=None):
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv)`` of
    self-attention with output ``out`` and its logsumexp ``lse`` (B, H, S),
    for the output cotangent ``dout`` — the reference's ``_bwd`` (delta,
    then the dq and dk/dv recomputations) op for op, densely. ``kv_mask``
    (B, S), >0 = attend: ``p = 0`` at every masked key."""
    return _bwd_plain_parts(q, k, v, dout, lse, _delta(out, dout), causal, kv_mask)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = False, kv_mask=None):
    """dq through ``csrc/flash_attention_bwd.cu`` for CUDA tensors (bf16,
    contiguous, 16-byte aligned, head dim 64 or 128; ``lse``/``delta``
    (B, H, S) f32; ``kv_mask`` None or (B, S) f32), the plain version for
    CPU tensors. Each launch adds one to
    ``flash_attention_bwd_dq.launches``, a masked one also to
    ``flash_attention_bwd_dq.masked_launches``, one at head dim 128 to
    ``flash_attention_bwd_dq.d128_launches``."""
    if not q.is_cuda:
        return _bwd_plain_parts(q, k, v, dout, lse, delta, causal, kv_mask)[0]
    ops = (("q", q), ("k", k), ("v", v), ("dout", dout))
    _check_kernel_operands(q, ops, 16)
    _check_row_stats(q, lse, delta)
    _check_kv_mask(q, kv_mask)
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    rc = _bwd_lib("cml_flash_attention_bwd_dq_bf16", 1)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _mask_ptr(kv_mask), dq.data_ptr(), b, s, h, d, int(causal), 1.0 / float(d) ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dq launch failed: CUDA error {rc}")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.masked_launches += kv_mask is not None
    flash_attention_bwd_dq.d128_launches += d == 128
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = False, kv_mask=None):
    """``(dk, dv)`` through ``csrc/flash_attention_bwd.cu`` for CUDA
    tensors, the plain version for CPU tensors (same operand rules as
    :func:`flash_attention_bwd_dq`). Each launch adds one to
    ``flash_attention_bwd_dkv.launches``, a masked one also to
    ``flash_attention_bwd_dkv.masked_launches``, one at head dim 128 to
    ``flash_attention_bwd_dkv.d128_launches``."""
    if not q.is_cuda:
        return _bwd_plain_parts(q, k, v, dout, lse, delta, causal, kv_mask)[1:]
    ops = (("q", q), ("k", k), ("v", v), ("dout", dout))
    _check_kernel_operands(q, ops, 16)
    _check_row_stats(q, lse, delta)
    _check_kv_mask(q, kv_mask)
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _bwd_lib("cml_flash_attention_bwd_dkv_bf16", 2)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _mask_ptr(kv_mask), dk.data_ptr(), dv.data_ptr(), b, s, h, d, int(causal),
        1.0 / float(d) ** 0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_dkv launch failed: CUDA error {rc}")
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.masked_launches += kv_mask is not None
    flash_attention_bwd_dkv.d128_launches += d == 128
    return dk, dv


def _check_row_stats(q, lse, delta) -> None:
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s) or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous (B, H, S) = {(b, h, s)} f32 tensor on {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` around the flash forward: saves
    ``q, k, v, o, lse`` and the f32 ``kv_mask`` (data: it gets no
    gradient); the backward is the dq and dk/dv wrappers (the kernels for
    CUDA tensors, their plain version for CPU ones), or with ``use_kernel``
    false the plain versions on any device."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, use_kernel):
        if q.is_cuda and use_kernel:
            out, lse = _forward(q, k, v, causal, True, kv_mask)
        else:
            out, lse = flash_attention_plain(
                q, k, v, causal=causal, kv_mask=kv_mask, dtype=q.dtype, return_lse=True
            )
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.use_kernel = causal, use_kernel
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        dout = dout.contiguous()
        delta = _delta(out, dout)
        if not ctx.use_kernel:
            return (*_bwd_plain_parts(q, k, v, dout, lse, delta, ctx.causal, kv_mask), None, None, None)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=ctx.causal, kv_mask=kv_mask)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=ctx.causal, kv_mask=kv_mask)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: torch.Tensor | None = None,  # (B, S), >0 = attend to that key
    dtype: torch.dtype = torch.bfloat16,
    return_lse: bool = False,
    use_kernel: bool = True,
):
    """Self-attention through the CUDA flash kernels (the reference's
    ``flash_attention`` contract, layout ``(B, S, H, D)``).

    A CPU tensor runs the plain versions, and so does any tensor with
    ``use_kernel=False`` (the plain tier: the forward and, under autograd,
    the reference's backward in plain ops). A CUDA tensor launches
    ``csrc/flash_attention_fwd.cu`` on the current stream (bf16,
    contiguous, 16-byte aligned, head dim 64 or 128) and, when autograd records
    the call, the backward kernels of ``csrc/flash_attention_bwd.cu``.
    ``kv_mask`` (the per-key padding mask, BERT's ``attention_mask``) goes
    to every kernel as one f32 row a batch, shared by the heads; a row
    that attends to no key gets what the reference gives it
    (:func:`flash_attention_plain`).
    """
    if kv_mask is not None:
        if tuple(kv_mask.shape) != tuple(q.shape[:2]):
            raise ValueError(f"kv_mask must be (batch, seq) = {tuple(q.shape[:2])}, got {tuple(kv_mask.shape)}")
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    needs_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if needs_grad:
        out, lse = _FlashAttention.apply(q, k, v, kv_mask, causal, use_kernel)
        out = out.to(dtype)
        return (out, lse) if return_lse else out
    if not q.is_cuda or not use_kernel:
        return flash_attention_plain(
            q, k, v, causal=causal, kv_mask=kv_mask, dtype=dtype, return_lse=return_lse
        )
    out, lse = _forward(q, k, v, causal, return_lse, kv_mask)
    out = out.to(dtype)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
# the masked form's launches (kv_mask given) and the head-dim-128 form's,
# counted besides
flash_attention.masked_launches = 0
flash_attention_bwd_dq.masked_launches = 0
flash_attention_bwd_dkv.masked_launches = 0
flash_attention.d128_launches = 0
flash_attention_bwd_dq.d128_launches = 0
flash_attention_bwd_dkv.d128_launches = 0
