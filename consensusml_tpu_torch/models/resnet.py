"""ResNet family (port of ``consensusml_tpu/models/resnet.py``): ResNet-18
and ResNet-50, the ImageNet (7x7/2 + max pool) or CIFAR (3x3) stem.

The modules mirror the flax tree one for one, so the parameters keep
flax's names and layouts and the gossiped tree (and with it the bucket
plan) equals the reference's: ``Conv_0.kernel`` (HWIO, f32),
``BottleneckBlock_3.Conv_1.kernel``, ``Dense_0.kernel`` (in, out); BN
layers are ``BatchNorm_N`` with ``norm_impl="flax"`` and
``FusedBatchNorm_N`` otherwise, each with f32 ``scale``/``bias``
parameters and ``mean``/``var`` buffers (the ``batch_stats`` collection).

The public forward takes NHWC images, as the reference does. Inside,
activations are ``channels_last`` NCHW tensors, so the ``(M, C)`` view
that the fused BN kernels read is a view and not a copy; each conv
kernel is cast (a copy anyway) from HWIO to a ``channels_last`` OIHW
weight at use. Padding is XLA's ``SAME`` (a stride-2 3x3 conv on an even
input pads one row and column after, none before).

``norm_impl``:

- ``"flax"`` (the default, as in the reference): BN through PyTorch's
  batch norm, with flax's semantics: the running variance is the biased
  batch variance, updated ``0.9 * old + 0.1 * batch``, and ReLU applied
  after the BN's output cast;
- ``"auto"``/``"pallas"``/``"interpret"``: every BN through the four
  fused-BN CUDA kernels on the card (:mod:`.fused_bn`; their plain
  versions on the CPU), ReLU fused where the reference fuses it;
  ``"jnp"``: the fused path's plain versions on any device.

BN statistics are updated in place in the modules' buffers during a
training forward; :func:`resnet_loss_fn` runs the model on clones of the
caller's ``batch_stats`` and returns them, so to its caller it is the
reference's functional ``mutable=["batch_stats"]`` apply.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from consensusml_tpu_torch.models.fused_bn import IMPLS as FUSED_IMPLS
from consensusml_tpu_torch.models.fused_bn import FusedBatchNorm
from consensusml_tpu_torch.models.losses import softmax_cross_entropy

__all__ = [
    "NORM_IMPLS",
    "BatchNorm",
    "BasicBlock",
    "BottleneckBlock",
    "ResNet",
    "resnet18",
    "resnet50",
    "resnet_loss_fn",
]

NORM_IMPLS = ("flax",) + FUSED_IMPLS


class BatchNorm(nn.Module):
    """``norm_impl="flax"``: flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
    dtype=x.dtype)`` then the optional ReLU, over channel axis 1, through
    PyTorch's batch norm (f32 statistics and arithmetic, the output in x's
    dtype, ReLU after that rounding). Training runs the batch norm with
    throwaway running buffers at torch momentum 1 (so they come back as
    the batch mean and unbiased variance in the same pass), then folds
    them into the flax statistics: ``var = unbiased * (n - 1) / n``,
    ``0.9 * old + 0.1 * batch``."""

    def __init__(self, features: int, *, act: str | None = None, scale_init: float = 1.0,
                 momentum: float = 0.9, epsilon: float = 1e-5, device=None):
        super().__init__()
        if act not in (None, "relu"):
            raise ValueError(f"unsupported act {act!r}")
        self.act, self.scale_init = act, scale_init
        self.momentum, self.epsilon = momentum, epsilon
        f32 = {"dtype": torch.float32, "device": device}
        self.scale = nn.Parameter(torch.full((features,), float(scale_init), **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    def forward(self, x: torch.Tensor, use_running_average: bool = False) -> torch.Tensor:
        if use_running_average:
            y = F.batch_norm(x, self.mean, self.var, self.scale, self.bias, training=False, eps=self.epsilon)
        else:
            n = x.numel() // x.shape[1]
            mean, unbiased = torch.zeros_like(self.mean), torch.zeros_like(self.var)
            y = F.batch_norm(x, mean, unbiased, self.scale, self.bias, training=True, momentum=1.0,
                             eps=self.epsilon)
            with torch.no_grad():
                var = unbiased * ((n - 1) / n)
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        return F.relu(y) if self.act == "relu" else y


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (s, s), padding="SAME",
    use_bias=False, dtype=dtype)``: an f32 HWIO ``kernel``, computed in
    ``dtype`` on ``channels_last`` NCHW input."""

    def __init__(self, in_features: int, features: int, kernel_size: int, strides: int = 1, *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.kernel_size, self.strides, self.dtype = kernel_size, strides, dtype
        self.kernel = nn.Parameter(
            torch.empty(kernel_size, kernel_size, in_features, features, dtype=torch.float32, device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.strides
        w = self.kernel.permute(3, 2, 0, 1).to(self.dtype, memory_format=torch.channels_last)
        (top, bottom), (left, right) = (same_pads(n, k, s) for n in x.shape[2:])
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=s, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=s)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: ``(before, after)``, the
    odd one after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")`` (padding
    with -inf) on NCHW ``x``."""
    (top, bottom), (left, right) = (same_pads(n, k, s) for n in x.shape[2:])
    return F.max_pool2d(F.pad(x, (left, right, top, bottom), value=float("-inf")), k, s)


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=float32)``: ``x @ kernel + bias``."""

    def __init__(self, in_features: int, features: int, *, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel + self.bias


NormFactory = Callable[..., nn.Module]


def _norm(norm: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """A BN (+ReLU) on ``channels_last`` NCHW ``x``; the fused one reads the
    NHWC view (its last axis)."""
    if isinstance(norm, FusedBatchNorm):
        return norm(x.permute(0, 2, 3, 1), use_running_average=not train).permute(0, 3, 1, 2)
    return norm(x, use_running_average=not train)


class _Block(nn.Module):
    """Registers submodules under flax's auto-names (``Conv_0``,
    ``BatchNorm_1``, ...) in the order the reference's compact call
    creates them."""

    def _setup(self, norm_kind: str, norm: NormFactory, dtype: torch.dtype, device) -> None:
        self._counts: dict[str, int] = {}
        self._norm_kind, self._norm_factory, self._dtype, self._device = norm_kind, norm, dtype, device

    def _add(self, kind: str, module: nn.Module) -> nn.Module:
        count = self._counts.get(kind, 0)
        self._counts[kind] = count + 1
        self.add_module(f"{kind}_{count}", module)
        return module

    def _conv(self, in_features: int, features: int, k: int, s: int = 1) -> nn.Module:
        return self._add("Conv", Conv(in_features, features, k, s, dtype=self._dtype, device=self._device))

    def _bn(self, features: int, **kw) -> nn.Module:
        return self._add(self._norm_kind, self._norm_factory(features, **kw))


class BottleneckBlock(_Block):
    """1x1 -> 3x3 (stride) -> 1x1 (4x), the last BN's scale zero-initialised
    (the residual branch starts as identity), projection shortcut when the
    shape changes."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, strides: int = 1, *, norm_kind: str, norm: NormFactory,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self._setup(norm_kind, norm, dtype, device)
        out = filters * 4
        self.layers = [
            (self._conv(in_features, filters, 1), self._bn(filters, act="relu")),
            (self._conv(filters, filters, 3, strides), self._bn(filters, act="relu")),
            (self._conv(filters, out, 1), self._bn(out, scale_init=0.0)),
        ]
        self.proj = None
        if strides != 1 or in_features != out:
            self.proj = (self._conv(in_features, out, 1, strides), self._bn(out))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = x
        for conv, norm in self.layers:
            y = _norm(norm, conv(y), train)
        residual = x if self.proj is None else _norm(self.proj[1], self.proj[0](x), train)
        return F.relu(residual + y)


class BasicBlock(_Block):
    """3x3 (stride) -> 3x3, the last BN's scale zero-initialised,
    projection shortcut when the shape changes (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, strides: int = 1, *, norm_kind: str, norm: NormFactory,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self._setup(norm_kind, norm, dtype, device)
        self.layers = [
            (self._conv(in_features, filters, 3, strides), self._bn(filters, act="relu")),
            (self._conv(filters, filters, 3), self._bn(filters, scale_init=0.0)),
        ]
        self.proj = None
        if strides != 1 or in_features != filters:
            self.proj = (self._conv(in_features, filters, 1, strides), self._bn(filters))

    forward = BottleneckBlock.forward


class ResNet(_Block):
    """Configurable ResNet (the reference's fields). ``forward(x, train)``
    takes NHWC images and returns f32 logits; in training each BN updates
    its running statistics in place."""

    def __init__(self, stage_sizes: Sequence[int], block: type, num_classes: int = 1000, width: int = 64,
                 stem: str = "imagenet", dtype: torch.dtype = torch.bfloat16, norm_impl: str = "flax",
                 norm_pack_small: bool = True, device=None):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem {stem!r}")
        if norm_impl == "flax":
            norm_kind = "BatchNorm"
            norm = lambda c, **kw: BatchNorm(c, device=device, **kw)  # noqa: E731
        elif norm_impl in FUSED_IMPLS:
            norm_kind = "FusedBatchNorm"
            norm = lambda c, **kw: FusedBatchNorm(  # noqa: E731
                c, impl=norm_impl, pack_small=norm_pack_small, device=device, **kw
            )
        else:
            raise ValueError(f"unknown norm_impl {norm_impl!r} (one of {NORM_IMPLS})")
        self.stage_sizes, self.num_classes, self.width = tuple(stage_sizes), num_classes, width
        self.stem, self.dtype, self.norm_impl = stem, dtype, norm_impl
        self._setup(norm_kind, norm, dtype, device)
        self.stem_layer = (self._conv(3, width, 7 if stem == "imagenet" else 3,
                                      2 if stem == "imagenet" else 1),
                           self._bn(width, act="relu"))
        features, blocks = width, []
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                blk = block(features, width * 2**i, 2 if i > 0 and j == 0 else 1, norm_kind=norm_kind,
                            norm=norm, dtype=dtype, device=device)
                blocks.append(self._add(block.__name__, blk))
                features = width * 2**i * block.expansion
        self.blocks = blocks
        self._add("Dense", Dense(features, num_classes, device=device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> channels_last NCHW (a view)
        conv, norm = self.stem_layer
        x = _norm(norm, conv(x), train)
        if self.stem == "imagenet":
            x = max_pool_same(x, 3, 2)
        for blk in self.blocks:
            x = blk(x, train)
        return self.Dense_0(x.mean(dim=(2, 3))).float()


def resnet18(num_classes: int = 10, stem: str = "cifar", dtype: torch.dtype = torch.bfloat16,
             norm_impl: str = "flax", device=None) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes=num_classes, stem=stem, dtype=dtype,
                  norm_impl=norm_impl, device=device)


def resnet50(num_classes: int = 1000, stem: str = "imagenet", dtype: torch.dtype = torch.bfloat16,
             norm_impl: str = "flax", norm_pack_small: bool = True, device=None) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes=num_classes, stem=stem, dtype=dtype,
                  norm_impl=norm_impl, norm_pack_small=norm_pack_small, device=device)


def resnet_loss_fn(model: ResNet):
    """``loss_fn(params, model_state, batch, generator) -> (loss,
    model_state)`` (the reference's ``resnet_loss_fn``): runs ``model``
    (structure only; ``meta`` is fine) with one worker's ``params`` (flax
    paths joined by dots) and a clone of ``model_state["batch_stats"]``
    through :func:`torch.func.functional_call` in training mode; returns
    the mean softmax cross-entropy of ``batch["label"]`` and the updated
    statistics. ``generator`` is unused (no dropout)."""

    def loss_fn(params, model_state, batch, generator):
        stats = {n: t.clone() for n, t in model_state["batch_stats"].items()}
        logits = functional_call(model, {**params, **stats}, (batch["image"],), {"train": True})
        return softmax_cross_entropy(logits, batch["label"]), {"batch_stats": stats}

    return loss_fn

