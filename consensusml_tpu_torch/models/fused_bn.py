"""Fused BatchNorm(+ReLU) for training: CUDA kernels + plain versions
(port of ``consensusml_tpu/models/fused_bn.py``).

Four kernels in ``csrc/fused_bn.cu``, each over a contiguous ``(M, C)``
view (channels last) of f32 or bf16 input, all arithmetic in f32:

- :func:`bn_stats`: per-channel f32 ``sum x`` and ``sum x**2``;
- :func:`bn_norm`: ``y = x * scale + shift`` (then ``max(y, 0)`` with
  relu), ``y`` in x's dtype;
- :func:`bn_bwd_reduce`: ``g = dy`` (zeroed where ``x * scale + shift <=
  0`` with relu); per-channel ``sum g`` and ``sum g * xhat``, ``xhat =
  (x - mean) * rsqrt``;
- :func:`bn_bwd_dx`: ``dx = scale * ((g - c1) - xhat * c2)``, in x's dtype.

Each wrapper runs its plain version (``*_plain``, beside it) for a CPU
tensor and launches its kernel for a CUDA tensor, raising on what the
kernel does not take (a non-contiguous view is refused, not copied); it
never falls back. Each launch adds one to the wrapper's ``launches``.

:func:`fused_batch_norm` is the reference's ``custom_vjp`` as a
``torch.autograd.Function``: forward = stats, then the "fast variance"
``var = max(sq/m - mean**2, 0)`` (not Welford's) and the folded
``scale``/``shift`` in f32 plain ops, then the normalize pass; backward =
the reduce pass, then the dx pass with ``c1 = dbeta/m``, ``c2 =
dgamma/m``. The statistics' cotangents are dropped, and ``mean``/``var``
come back detached (the mutable-state convention).

``impl``: ``"auto"``, ``"pallas"`` and ``"interpret"`` all run the four
wrappers (the kernels on the card, the plain versions on the CPU);
``"jnp"`` names the plain versions on any device (the reference's jnp
path, the parity oracle; ``chip_smoke.py`` runs it on the card beside
the kernels). ``pack_small`` is accepted and does nothing: packing rows
of a narrow C into the TPU's 128 lanes is a TPU layout device, and the
CUDA kernels read any C in 16-byte vectors (or one element a thread when
C is not a multiple of the vector width).
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from consensusml_tpu_torch import kernels

__all__ = [
    "IMPLS",
    "fused_batch_norm",
    "FusedBatchNorm",
    "fold_params",
    "bn_stats",
    "bn_stats_plain",
    "bn_norm",
    "bn_norm_plain",
    "bn_bwd_reduce",
    "bn_bwd_reduce_plain",
    "bn_bwd_dx",
    "bn_bwd_dx_plain",
]

IMPLS = ("auto", "pallas", "jnp", "interpret")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes
_THREADS = 256
_FILL_BLOCKS = 528  # 132 SMs x 4 blocks of 256 threads
_ROWS_A_THREAD = 32
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch ops, f32)
# ---------------------------------------------------------------------------


def bn_stats_plain(x2: torch.Tensor):
    """``(sum x, sum x**2)`` per channel of ``(M, C)`` ``x2``, in f32."""
    xf = x2.float()
    return xf.sum(0), (xf * xf).sum(0)


def bn_norm_plain(x2: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """``x * scale + shift`` (each product and sum rounded on its own),
    then relu; in x's dtype."""
    y = x2.float() * scale + shift
    if relu:
        y = torch.relu(y)
    return y.to(x2.dtype)


def _masked_g(dy2, x2, scale, shift, relu: bool) -> torch.Tensor:
    g = dy2.float()
    if relu:
        g = torch.where(x2.float() * scale + shift > 0, g, 0.0)
    return g


def bn_bwd_reduce_plain(dy2, x2, scale, shift, mean, rsqrt, relu: bool):
    """``(dbeta, dgamma) = (sum g, sum g * xhat)`` per channel, in f32."""
    g = _masked_g(dy2, x2, scale, shift, relu)
    xhat = (x2.float() - mean) * rsqrt
    return g.sum(0), (g * xhat).sum(0)


def bn_bwd_dx_plain(dy2, x2, scale, shift, mean, rsqrt, c1, c2, relu: bool) -> torch.Tensor:
    """``dx = scale * ((g - c1) - xhat * c2)``, in x's dtype."""
    g = _masked_g(dy2, x2, scale, shift, relu)
    xhat = (x2.float() - mean) * rsqrt
    return (scale * (g - c1 - xhat * c2)).to(x2.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_view(name: str, t: torch.Tensor, like: torch.Tensor | None = None) -> None:
    if t.dim() != 2 or t.dtype not in _DTYPE_CODE or not t.is_contiguous() or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(
            f"{name} must be a contiguous (M, C) f32 or bf16 tensor with M, C >= 1 (the kernels read a "
            f"view and never copy one), got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if t.shape[1] >= 2**31:
        raise ValueError(f"{name}: C = {t.shape[1]} does not fit the kernels' int")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype or t.device != like.device):
        raise ValueError(
            f"{name} must match x: {like.dtype} {tuple(like.shape)} on {like.device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _check_vectors(x2: torch.Tensor, **vecs: torch.Tensor) -> None:
    c = x2.shape[1]
    for name, v in vecs.items():
        if v.dtype != torch.float32 or tuple(v.shape) != (c,) or not v.is_contiguous() or v.device != x2.device:
            raise ValueError(
                f"{name} must be a contiguous ({c},) f32 tensor on {x2.device}, got "
                f"{v.dtype} {tuple(v.shape)} on {v.device}"
            )


def _vec(x2: torch.Tensor, *tensors: torch.Tensor) -> int:
    """The kernels' vector width: 16 bytes of x's dtype when C is a multiple
    of it and every operand is 16-byte aligned, else one element."""
    width = _VEC[x2.dtype]
    if x2.shape[1] % width or any(t.data_ptr() % 16 for t in (x2, *tensors)):
        return 1
    return width


def _stripes(m: int, c: int, vec: int) -> int:
    """Row stripes of the reductions (one block per stripe and channel tile,
    the same tile geometry as ``csrc/fused_bn.cu:reduce_plan``): enough to
    fill the card, or each thread walking at least 32 rows, whichever is
    fewer; never fewer than one row a thread, and no stripe empty."""
    cols = -(-c // vec)
    tx = min(1 << (cols - 1).bit_length(), 32)
    ty = _THREADS // tx
    tiles = -(-cols // tx)
    stripes = max(1, min(max(-(-m // (ty * _ROWS_A_THREAD)), -(-_FILL_BLOCKS // tiles)), -(-m // ty)))
    # the kernel gives each stripe ceil(m / stripes) rows: drop stripes
    # that would be left without any
    while (fewer := -(-m // -(-m // stripes))) != stripes:
        stripes = fewer
    return stripes


def _bind(symbol: str, argtypes: list):
    fn = getattr(kernels.load("fused_bn"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launched(wrapper, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error {rc}")
    wrapper.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def bn_stats(x2: torch.Tensor):
    """``(sum x, sum x**2)`` per channel of ``(M, C)`` ``x2`` (f32 or bf16),
    f32: ``csrc/fused_bn.cu`` for a CUDA tensor, :func:`bn_stats_plain`
    for a CPU one. Each launch adds one to ``bn_stats.launches``."""
    if not x2.is_cuda:
        return bn_stats_plain(x2)
    _check_view("x", x2)
    m, c = x2.shape
    vec = _vec(x2)
    stripes = _stripes(m, c, vec)
    partials = torch.empty((stripes, 2, c), dtype=torch.float32, device=x2.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    rc = _bind("cml_bn_stats", [_P, _I, _LL, _I, _I, _I, _P, _P, _P])(
        x2.data_ptr(), _DTYPE_CODE[x2.dtype], m, c, vec, stripes, partials.data_ptr(), out.data_ptr(),
        _stream(x2),
    )
    _launched(bn_stats, rc)
    return out[0], out[1]


def bn_norm(x2: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """``x * scale + shift`` (then relu) in x's dtype: ``csrc/fused_bn.cu``
    for a CUDA tensor, :func:`bn_norm_plain` for a CPU one. ``scale`` and
    ``shift`` are contiguous ``(C,)`` f32. Each launch adds one to
    ``bn_norm.launches``."""
    if not x2.is_cuda:
        return bn_norm_plain(x2, scale, shift, relu)
    _check_view("x", x2)
    _check_vectors(x2, scale=scale, shift=shift)
    m, c = x2.shape
    y = torch.empty_like(x2)
    rc = _bind("cml_bn_norm", [_P, _I, _LL, _I, _I, _P, _P, _I, _P, _P])(
        x2.data_ptr(), _DTYPE_CODE[x2.dtype], m, c, _vec(x2, y, scale, shift), scale.data_ptr(),
        shift.data_ptr(), int(relu), y.data_ptr(), _stream(x2),
    )
    _launched(bn_norm, rc)
    return y


def bn_bwd_reduce(dy2, x2, scale, shift, mean, rsqrt, relu: bool):
    """``(dbeta, dgamma) = (sum g, sum g * xhat)`` per channel, f32:
    ``csrc/fused_bn.cu`` for CUDA tensors, :func:`bn_bwd_reduce_plain` for
    CPU ones. ``dy2`` has x's shape and dtype. Each launch adds one to
    ``bn_bwd_reduce.launches``."""
    if not x2.is_cuda:
        return bn_bwd_reduce_plain(dy2, x2, scale, shift, mean, rsqrt, relu)
    _check_view("x", x2)
    _check_view("dy", dy2, like=x2)
    vecs = {"scale": scale, "shift": shift, "mean": mean, "rsqrt": rsqrt}
    _check_vectors(x2, **vecs)
    m, c = x2.shape
    vec = _vec(x2, dy2, *vecs.values())
    stripes = _stripes(m, c, vec)
    partials = torch.empty((stripes, 2, c), dtype=torch.float32, device=x2.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    rc = _bind("cml_bn_bwd_reduce", [_P, _P, _I, _LL, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P])(
        dy2.data_ptr(), x2.data_ptr(), _DTYPE_CODE[x2.dtype], m, c, vec, stripes, scale.data_ptr(),
        shift.data_ptr(), mean.data_ptr(), rsqrt.data_ptr(), int(relu), partials.data_ptr(), out.data_ptr(),
        _stream(x2),
    )
    _launched(bn_bwd_reduce, rc)
    return out[0], out[1]


def bn_bwd_dx(dy2, x2, scale, shift, mean, rsqrt, c1, c2, relu: bool) -> torch.Tensor:
    """``dx = scale * ((g - c1) - xhat * c2)`` in x's dtype:
    ``csrc/fused_bn.cu`` for CUDA tensors, :func:`bn_bwd_dx_plain` for CPU
    ones. Each launch adds one to ``bn_bwd_dx.launches``."""
    if not x2.is_cuda:
        return bn_bwd_dx_plain(dy2, x2, scale, shift, mean, rsqrt, c1, c2, relu)
    _check_view("x", x2)
    _check_view("dy", dy2, like=x2)
    vecs = {"scale": scale, "shift": shift, "mean": mean, "rsqrt": rsqrt, "c1": c1, "c2": c2}
    _check_vectors(x2, **vecs)
    m, c = x2.shape
    dx = torch.empty_like(x2)
    rc = _bind("cml_bn_bwd_dx", [_P, _P, _I, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P])(
        dy2.data_ptr(), x2.data_ptr(), _DTYPE_CODE[x2.dtype], m, c, _vec(x2, dy2, dx, *vecs.values()),
        *(v.data_ptr() for v in vecs.values()), int(relu), dx.data_ptr(), _stream(x2),
    )
    _launched(bn_bwd_dx, rc)
    return dx


bn_stats.launches = 0
bn_norm.launches = 0
bn_bwd_reduce.launches = 0
bn_bwd_dx.launches = 0

_KERNEL_OPS = (bn_stats, bn_norm, bn_bwd_reduce, bn_bwd_dx)
_PLAIN_OPS = (bn_stats_plain, bn_norm_plain, bn_bwd_reduce_plain, bn_bwd_dx_plain)


# ---------------------------------------------------------------------------
# functional forward/backward (the reference's custom VJP)
# ---------------------------------------------------------------------------


def fold_params(gamma, beta, mean, var, eps: float):
    """``(scale, shift, rsqrt)``: ``rsqrt(var + eps)``, ``gamma * rsqrt``,
    ``beta - mean * scale``, in f32 (the reference's ``_fold_params``)."""
    rsqrt = torch.rsqrt(var + eps)
    scale = gamma.float() * rsqrt
    shift = beta.float() - mean * scale
    return scale, shift, rsqrt


class _FusedBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, relu, plain):
        stats, norm, _r, _d = _PLAIN_OPS if plain else _KERNEL_OPS
        m = x2.shape[0]
        s, sq = stats(x2)
        mean = s / m
        var = torch.clamp_min(sq / m - mean * mean, 0.0)
        scale, shift, rsqrt = fold_params(gamma, beta, mean, var, eps)
        y = norm(x2, scale, shift, relu)
        ctx.save_for_backward(x2, scale, shift, mean, rsqrt)
        ctx.relu, ctx.plain = relu, plain
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2, scale, shift, mean, rsqrt = ctx.saved_tensors
        _s, _n, reduce, dx_pass = _PLAIN_OPS if ctx.plain else _KERNEL_OPS
        m = x2.shape[0]
        dy = dy.to(x2.dtype).contiguous()
        db, dg = reduce(dy, x2, scale, shift, mean, rsqrt, ctx.relu)
        dx = dx_pass(dy, x2, scale, shift, mean, rsqrt, db / m, dg / m, ctx.relu)
        return dx, dg, db, None, None, None


def fused_batch_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-5,
    act: str | None = None,
    impl: str = "auto",
    pack_small: bool = True,
):
    """Training-mode fused BN over the last axis of ``x``: ``(y, mean,
    var)``, ``y`` in x's dtype and shape, ``mean``/``var`` the f32 batch
    statistics (biased variance), detached. Gradients reach ``x``,
    ``gamma`` and ``beta`` through the statistics as in standard BN.

    ``act``: ``None`` or ``"relu"`` (fused into the normalize pass and its
    backward mask). ``impl`` and ``pack_small``: see the module docstring.
    ``x`` must be viewable as ``(M, C)`` without a copy.
    """
    if act not in (None, "relu"):
        raise ValueError(f"unsupported act {act!r}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    c = x.shape[-1]
    x2 = x.view(-1, c)
    y, mean, var = _FusedBatchNorm.apply(x2, gamma, beta, eps, act == "relu", impl == "jnp")
    return y.view(x.shape), mean, var


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------


class FusedBatchNorm(nn.Module):
    """BatchNorm(+ReLU) over the feature (last) axis, the reference's
    ``FusedBatchNorm`` state contract: f32 parameters ``scale``/``bias``
    and ``batch_stats`` buffers ``mean``/``var``, updated in place in
    training as ``momentum * old + (1 - momentum) * batch`` (flax's
    momentum, 0.9). ``forward(x, use_running_average=True)`` (the
    reference's field of that name, given per call as the ResNet's
    ``train`` flag is) normalises with the running statistics in plain f32
    ops, as the reference does in jnp."""

    def __init__(self, features: int, *, momentum: float = 0.9, epsilon: float = 1e-5, act: str | None = None,
                 impl: str = "auto", pack_small: bool = True, scale_init: float = 1.0, device=None):
        super().__init__()
        if act not in (None, "relu"):
            raise ValueError(f"unsupported act {act!r}")
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}")
        self.momentum, self.epsilon, self.act = momentum, epsilon, act
        self.impl, self.pack_small, self.scale_init = impl, pack_small, scale_init
        f32 = {"dtype": torch.float32, "device": device}
        self.scale = nn.Parameter(torch.full((features,), float(scale_init), **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    def forward(self, x: torch.Tensor, use_running_average: bool = False) -> torch.Tensor:
        if use_running_average:
            scale, shift, _ = fold_params(self.scale, self.bias, self.mean, self.var, self.epsilon)
            y = x.float() * scale + shift
            if self.act == "relu":
                y = torch.relu(y)
            return y.to(x.dtype)
        y, mean, var = fused_batch_norm(x, self.scale, self.bias, eps=self.epsilon, act=self.act,
                                        impl=self.impl, pack_small=self.pack_small)
        with torch.no_grad():
            self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
            self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        return y
