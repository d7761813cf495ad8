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
never falls back. Each launch adds one to the wrapper's ``launches``. Under a
``workcount`` counter each wrapper reports its function's work from its
shapes (``workcount.counted``) and runs with counting suspended; a fake
tensor (the counting pass's) takes the plain route, on ``meta`` copies.

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
import functools
from typing import NamedTuple

import torch
from torch import nn

from consensusml_tpu_torch import kernels
from consensusml_tpu_torch.numerics import ftz, inv_rows
from consensusml_tpu_torch.workcount import counted, on_card

__all__ = [
    "IMPLS",
    "fused_layer_norm",
    "FusedLayerNorm",
    "ln_fwd",
    "ln_fwd_plain",
    "ln_bwd",
    "ln_bwd_plain",
    "BwdPlan",
    "ln_bwd_plan",
]

IMPLS = ("auto", "pallas", "jnp")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = 8  # elements a thread loads at once (one 16-byte bf16 or two f32 vectors)
_MAX_H = 4096  # csrc/fused_ln.cu holds a row in the registers of at most 256 threads
_BWD_WARPS = 8  # warps of a backward block (csrc/fused_ln.cu: kBwdWarps)
_BWD_SLOTS = 2  # rows of x and dy a row group stages ahead (tools/norm_sweep.py: 2 beat 1, 3 and 4)
_SMEM_LIMIT = 232448 - 1024  # an H100 block's shared memory, less the kernel's static words
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch ops, f32)
# ---------------------------------------------------------------------------


def _mean(t: torch.Tensor, inv: float) -> torch.Tensor:
    # the compiled reference's jnp.mean: the row sum times f32(1/H)
    return ftz(ftz(t.sum(1, keepdim=True)) * inv)


def _row_stats(x2: torch.Tensor, eps: float):
    """``(xc, rsig)`` of each row, flushed after every operation."""
    xf = ftz(x2.float())
    inv = inv_rows(xf.shape[1])
    xc = ftz(xf - _mean(xf, inv))
    return xc, torch.rsqrt(_mean(ftz(xc * xc), inv) + eps)


def ln_fwd_plain(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``xc * rsig * gamma + beta`` of ``(M, H)`` ``x2`` in f32, then
    ``out_dtype``: the reference's ``_ln_fwd_kernel``, each operation's
    operands and result flushed as its compiled program does."""
    xc, rsig = _row_stats(x2, eps)
    return ftz(ftz(ftz(xc * rsig) * ftz(gamma)) + ftz(beta)).to(out_dtype)


def ln_bwd_plain(dy2: torch.Tensor, x2: torch.Tensor, gamma: torch.Tensor, eps: float):
    """``(dx, dgamma, dbeta)``: ``dx`` in x's dtype, the column sums in
    f32, the reference's ``_ln_bwd_kernel``, flushed as
    :func:`ln_fwd_plain`."""
    xc, rsig = _row_stats(x2, eps)
    inv = inv_rows(x2.shape[1])
    xhat = ftz(xc * rsig)
    dyf = ftz(dy2.float())
    g = ftz(dyf * ftz(gamma))
    m1, m2 = _mean(g, inv), _mean(ftz(g * xhat), inv)
    dx = ftz(rsig * ftz(ftz(g - m1) - ftz(xhat * m2))).to(x2.dtype)
    return dx, ftz(ftz(dyf * xhat).sum(0)), ftz(dyf.sum(0))


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


class BwdPlan(NamedTuple):
    """How :func:`ln_bwd` cuts an ``(M, H)`` view (``csrc/fused_ln.cu``'s
    header): ``group`` warps a row, ``blocks`` persistent blocks of 8 warps
    (``8 / group`` row groups each), ``slots`` rows of x and dy staged
    ahead by each row group, ``smem`` bytes of dynamic shared memory a
    block."""

    group: int
    blocks: int
    slots: int
    smem: int


@functools.lru_cache(maxsize=None)
def ln_bwd_plan(m: int, h: int, x_elem: int, dy_elem: int, sms: int, *, slots: int | None = None) -> BwdPlan:
    """The plan of :func:`ln_bwd` for an ``(m, h)`` view of ``x_elem``-byte
    x and ``dy_elem``-byte dy on a card of ``sms`` SMs: one warp a row up
    to H = 1024 (a thread then holds four 8-column vectors), two up to
    2048, four up to 4096; one block an SM, fewer where the rows leave a
    row group without rows; a ring of 2 rows a row group (on the H100 at
    GPT-2-medium's shapes 2 beat 1, 3 and 4 rows: ``tools/norm_sweep.py``,
    PERF.md). ``slots`` pins the ring's depth."""
    group = 1 if h <= 1024 else 2 if h <= 2048 else 4
    groups = _BWD_WARPS // group
    blocks = max(1, min(sms, -(-m // groups)))
    per_slot = groups * h * (x_elem + dy_elem)
    fixed = groups * 4 * group * 4  # the row groups' reduction words
    slots = slots or min(_BWD_SLOTS, (_SMEM_LIMIT - fixed) // per_slot)
    smem = max(slots * per_slot, groups * 2 * h * 4, 1024) + fixed
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a ring of {slots} rows of ({h},) x and dy does not fit in {_SMEM_LIMIT} bytes")
    return BwdPlan(group, blocks, slots, smem)


_TICKETS: dict[torch.device, torch.Tensor] = {}


def _ticket(device: torch.device) -> torch.Tensor:
    """The backward's two uint32 ticket words on ``device``: zero before a
    launch, and left zero by it (launches on one stream run one at a
    time)."""
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return t


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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



def _ln_fwd_work(x2, gamma, beta, eps=1e-6, out_dtype=None):
    """8 operations an element; reads x, writes y (``out_dtype``), reads
    gamma and beta (f32)."""
    n, h = x2.numel(), x2.shape[-1]
    return 8.0 * n, float(x2.element_size() * n + (out_dtype or torch.float32).itemsize * n + 8 * h)


def _ln_bwd_work(dy2, x2, gamma, eps=1e-6, *, plan=None):
    """16 operations an element; reads dy and x, writes dx, reads gamma and
    writes dgamma and dbeta (f32)."""
    n, h = x2.numel(), x2.shape[-1]
    return 16.0 * n, float((dy2.element_size() + 2 * x2.element_size()) * n + 12 * h)


@counted(_ln_fwd_work)
def ln_fwd(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Row LayerNorm of ``(M, H)`` ``x2`` (f32 or bf16) into ``out_dtype``
    (f32 or bf16; default f32): ``csrc/fused_ln.cu`` for a CUDA tensor,
    :func:`ln_fwd_plain` for a CPU one. Each launch adds one to
    ``ln_fwd.launches``."""
    out_dtype = out_dtype or torch.float32
    if not on_card(x2):
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


@counted(_ln_bwd_work)
def ln_bwd(dy2: torch.Tensor, x2: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6, *,
           plan: BwdPlan | None = None):
    """``(dx, dgamma, dbeta)`` of the row LayerNorm: ``dx`` in x's dtype,
    ``dgamma``/``dbeta`` ``(H,)`` f32 (``dy2`` f32 or bf16, x's shape):
    one launch of ``csrc/fused_ln.cu`` for CUDA tensors (``plan``, by
    default :func:`ln_bwd_plan`'s; the column sums folded in a fixed block
    order after an integer ticket: no float atomics, a rerun gives the same
    bits), :func:`ln_bwd_plain` for CPU ones. Each launch adds one to
    ``ln_bwd.launches``."""
    if not on_card(x2):
        return ln_bwd_plain(dy2, x2, gamma, eps)
    _check_rows("x", x2)
    _check_rows("dy", dy2, like=x2)
    _check_vectors(x2, gamma=gamma)
    m, h = x2.shape
    dx = torch.empty_like(x2)
    out = (torch.empty if m else torch.zeros)((2, h), dtype=torch.float32, device=x2.device)
    if m:
        p = plan or ln_bwd_plan(m, h, x2.element_size(), dy2.element_size(), _sms(x2.device))
        partials = torch.empty((p.blocks, 2, h), dtype=torch.float32, device=x2.device)
        rc = _bind("cml_ln_bwd", [_P, _I, _P, _I, _P, _P, _LL, _I, _F, _I, _I, _I, _P, _P, _P, _P])(
            dy2.data_ptr(), _DTYPE_CODE[dy2.dtype], x2.data_ptr(), _DTYPE_CODE[x2.dtype], gamma.data_ptr(),
            dx.data_ptr(), m, h, eps, p.group, p.blocks, p.slots, partials.data_ptr(),
            _ticket(x2.device).data_ptr(), out.data_ptr(), torch.cuda.current_stream(x2.device).cuda_stream,
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
