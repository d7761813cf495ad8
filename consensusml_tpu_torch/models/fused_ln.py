"""Fused LayerNorm for training: CUDA kernels + plain versions (port of
``consensusml_tpu/models/fused_ln.py``).

Two kernels in ``csrc/fused_ln.cu``, each over a contiguous ``(M, H)``
view (normalised over H), all arithmetic in f32:

- :func:`ln_fwd`: per row ``mu = mean(x)``, ``xc = x - mu``, ``var =
  mean(xc**2)`` (two passes over the resident row, not ``E[x**2] -
  E[x]**2``), ``y = xc * rsqrt(var + eps) * gamma + beta`` in
  ``out_dtype``;
- :func:`ln_bwd`: per row the statistics again, ``g = dy * gamma``,
  ``dx = rsig * (g - mean(g) - xhat * mean(g * xhat))`` in x's dtype;
  per column ``dgamma = sum dy * xhat`` and ``dbeta = sum dy`` in f32.

Each wrapper runs its plain version (``*_plain``, beside it) for a CPU
tensor and launches its kernel for a CUDA tensor, raising on what the
kernel does not take (a non-contiguous view is refused, not copied); it
never falls back. Each launch adds one to the wrapper's ``launches``.

:func:`fused_layer_norm` is the reference's ``custom_vjp`` as a
``torch.autograd.Function``: it saves only ``(x, gamma)`` and the
backward recomputes the row statistics. :class:`FusedLayerNorm` is the
module, with f32 parameters ``scale`` and ``bias`` as flax names them, so
GPT-2's parameter tree, its conversion and the gossip's bucket plan are
the same under either LayerNorm.

``impl``: ``"auto"`` and ``"pallas"`` run the two wrappers (the kernels
on the card, the plain versions on the CPU); ``"jnp"`` names the plain
versions on any device (the reference's jnp path, the parity oracle that
``chip_smoke.py`` runs on the card beside the kernels).
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from consensusml_tpu_torch import kernels

__all__ = [
    "IMPLS",
    "fused_layer_norm",
    "FusedLayerNorm",
    "ln_fwd",
    "ln_fwd_plain",
    "ln_bwd",
    "ln_bwd_plain",
]

IMPLS = ("auto", "pallas", "jnp")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = 8  # elements a thread loads at once (one 16-byte bf16 or two f32 vectors)
_MAX_H = 4096  # csrc/fused_ln.cu holds a row in the registers of at most 256 threads
_TARGET_STRIPES = 1024  # the backward's row stripes: about 8 blocks of 128 threads an SM
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch ops, f32)
# ---------------------------------------------------------------------------


def _row_stats(xf: torch.Tensor, eps: float):
    mu = xf.mean(1, keepdim=True)
    xc = xf - mu
    return xc, torch.rsqrt((xc * xc).mean(1, keepdim=True) + eps)


def ln_fwd_plain(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``xc * rsig * gamma + beta`` of ``(M, H)`` ``x2`` in f32, then
    ``out_dtype``: the reference's ``_ln_fwd_kernel``."""
    xc, rsig = _row_stats(x2.float(), eps)
    return (xc * rsig * gamma + beta).to(out_dtype)


def ln_bwd_plain(dy2: torch.Tensor, x2: torch.Tensor, gamma: torch.Tensor, eps: float):
    """``(dx, dgamma, dbeta)``: ``dx`` in x's dtype, the column sums in
    f32, the reference's ``_ln_bwd_kernel``."""
    xc, rsig = _row_stats(x2.float(), eps)
    xhat = xc * rsig
    dyf = dy2.float()
    g = dyf * gamma
    m1 = g.mean(1, keepdim=True)
    m2 = (g * xhat).mean(1, keepdim=True)
    dx = (rsig * (g - m1 - xhat * m2)).to(x2.dtype)
    return dx, (dyf * xhat).sum(0), dyf.sum(0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor | None = None) -> None:
    if (t.dim() != 2 or t.dtype not in _DTYPE_CODE or not t.is_contiguous() or t.data_ptr() % 16
            or t.shape[1] % _VEC or not _VEC <= t.shape[1] <= _MAX_H):
        raise ValueError(
            f"{name} must be a contiguous, 16-byte aligned (M, H) f32 or bf16 tensor with H a multiple of "
            f"{_VEC} in [{_VEC}, {_MAX_H}] (the kernels read a view and never copy one), got {t.dtype} "
            f"{tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if like is not None and (t.shape != like.shape or t.device != like.device):
        raise ValueError(f"{name} must have x's shape {tuple(like.shape)} on {like.device}, got "
                         f"{tuple(t.shape)} on {t.device}")


def _check_vectors(x2: torch.Tensor, **vecs: torch.Tensor) -> None:
    h = x2.shape[1]
    for name, v in vecs.items():
        if (v.dtype != torch.float32 or tuple(v.shape) != (h,) or not v.is_contiguous()
                or v.device != x2.device or v.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned ({h},) f32 tensor on {x2.device}, "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")


def _stripes(m: int) -> int:
    """Row stripes of the backward's column sums: about
    ``_TARGET_STRIPES``, none empty (each holds ``ceil(m / stripes)``
    rows but the last)."""
    rows = -(-m // _TARGET_STRIPES)
    return -(-m // rows)


def _bind(symbol: str, argtypes: list):
    fn = getattr(kernels.load("fused_ln"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launched(wrapper, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error {rc}")
    wrapper.launches += 1


def ln_fwd(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Row LayerNorm of ``(M, H)`` ``x2`` (f32 or bf16) into ``out_dtype``
    (f32 or bf16; default f32): ``csrc/fused_ln.cu`` for a CUDA tensor,
    :func:`ln_fwd_plain` for a CPU one. Each launch adds one to
    ``ln_fwd.launches``."""
    out_dtype = out_dtype or torch.float32
    if not x2.is_cuda:
        return ln_fwd_plain(x2, gamma, beta, eps, out_dtype)
    _check_rows("x", x2)
    _check_vectors(x2, gamma=gamma, beta=beta)
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    m, h = x2.shape
    y = torch.empty((m, h), dtype=out_dtype, device=x2.device)
    if m:
        rc = _bind("cml_ln_fwd", [_P, _I, _P, _P, _P, _I, _LL, _I, _F, _P])(
            x2.data_ptr(), _DTYPE_CODE[x2.dtype], gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            _DTYPE_CODE[out_dtype], m, h, eps, torch.cuda.current_stream(x2.device).cuda_stream,
        )
        _launched(ln_fwd, rc)
    return y


def ln_bwd(dy2: torch.Tensor, x2: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """``(dx, dgamma, dbeta)`` of the row LayerNorm: ``dx`` in x's dtype,
    ``dgamma``/``dbeta`` ``(H,)`` f32 (``dy2`` f32 or bf16, x's shape):
    ``csrc/fused_ln.cu`` for CUDA tensors (the rows, then a fixed-order
    fold of the column sums' stripes: no atomics, a rerun gives the same
    bits), :func:`ln_bwd_plain` for CPU ones. Each call adds one to
    ``ln_bwd.launches``."""
    if not x2.is_cuda:
        return ln_bwd_plain(dy2, x2, gamma, eps)
    _check_rows("x", x2)
    _check_rows("dy", dy2, like=x2)
    _check_vectors(x2, gamma=gamma)
    m, h = x2.shape
    dx = torch.empty_like(x2)
    out = (torch.empty if m else torch.zeros)((2, h), dtype=torch.float32, device=x2.device)
    if m:
        stripes = _stripes(m)
        partials = torch.empty((stripes, 2, h), dtype=torch.float32, device=x2.device)
        rc = _bind("cml_ln_bwd", [_P, _I, _P, _I, _P, _P, _LL, _I, _F, _I, _P, _P, _P])(
            dy2.data_ptr(), _DTYPE_CODE[dy2.dtype], x2.data_ptr(), _DTYPE_CODE[x2.dtype], gamma.data_ptr(),
            dx.data_ptr(), m, h, eps, stripes, partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
        _launched(ln_bwd, rc)
    return dx, out[0], out[1]


ln_fwd.launches = 0
ln_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd function and module
# ---------------------------------------------------------------------------


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, out_dtype, plain):
        ctx.save_for_backward(x2, gamma)
        ctx.eps, ctx.plain = eps, plain
        return (ln_fwd_plain if plain else ln_fwd)(x2, gamma, beta, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x2, gamma = ctx.saved_tensors
        bwd = ln_bwd_plain if ctx.plain else ln_bwd
        dx, dgamma, dbeta = bwd(dy.contiguous(), x2, gamma, ctx.eps)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None, None, None


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6,
                     out_dtype: torch.dtype | None = None, impl: str = "auto") -> torch.Tensor:
    """LayerNorm over the last axis: ``(x - mu) * rsqrt(var + eps) * gamma +
    beta`` in f32, output in ``out_dtype`` (default f32, the flax
    convention). Differentiable in ``x``, ``gamma`` and ``beta``; the
    backward recomputes the row statistics from ``x``. ``x`` must be
    viewable as ``(M, H)`` without a copy. ``impl``: see the module
    docstring."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (one of {IMPLS})")
    h = x.shape[-1]
    y = _FusedLayerNorm.apply(x.view(-1, h), gamma, beta, eps, out_dtype or torch.float32, impl == "jnp")
    return y.view(x.shape)


class FusedLayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` replaced by the fused kernels (the reference's
    ``FusedLayerNorm``): f32 ``scale`` (ones) and ``bias`` (zeros),
    epsilon 1e-6, output in ``out_dtype`` (bf16 when a bf16 matmul consumes
    it: the same numbers as f32 out then cast, half the bytes); ``impl`` as
    :func:`fused_layer_norm`'s."""

    def __init__(self, features: int, out_dtype: torch.dtype | None = None, eps: float = 1e-6,
                 impl: str = "auto", device=None):
        super().__init__()
        self.eps, self.out_dtype, self.impl = eps, out_dtype, impl
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.scale, self.bias, self.eps, self.out_dtype, self.impl)
