"""GPT-2 decoder (port of ``consensusml_tpu/models/gpt2.py``).

Pre-LN transformer, learned positions, tanh-GELU, tied LM head — the
reference's architecture and numerics, written as ``nn.Module``s whose
parameters mirror the flax tree one for one: the module path of every
parameter is its flax path joined by dots (``h_0.qkv.kernel``,
``wte.embedding``, ``ln_f.scale``), in flax's shapes, so a flax tree
loads without any copy (:func:`.convert.gpt2_from_flax`) and the
gossip's bucket layout (flatten order, chunk boundaries) is the
reference's.

- Parameters are float32, as flax's ``param_dtype``; every Dense and
  embedding casts its parameters to the compute ``dtype`` per op, as
  flax's ``promote_dtype`` does, so an optimiser updates f32 masters.
  :meth:`GPT2LM.to_compute_dtype` casts those parameters once, for
  serving: the per-op casts then do nothing and the values are the same;
- Dense kernels are stored ``(in, out)``: ``qkv`` as ``(hidden, heads,
  3 * d_head)`` (each head's q | k | v together), ``out`` as ``(heads,
  d_head, hidden)``; they are applied as reshaped views, no transposes;
- LayerNorm is flax's by default (``norm_impl="flax"``): epsilon 1e-6,
  f32 math on the promoted input, fast variance ``E[x^2] - E[x]^2``
  clipped at 0, f32 output; ``norm_impl="pallas"`` swaps every LayerNorm
  for :class:`.fused_ln.FusedLayerNorm` (two-pass variance from the
  resident row, output in the compute dtype), the CUDA kernels on the
  card and their plain versions on the CPU, as the reference's field of
  that name does (``"jnp"``: the plain versions on any device, the
  reference's jnp path);
- Dense layers cast their input to the compute dtype, multiply, then add
  the bias as a separate op (flax's two bf16 roundings);
- dropout at the reference's three sites (after the embedding sum, after
  the attention projection, after the MLP), drawn from an explicit
  ``torch.Generator`` when ``deterministic=False``; its bits cannot equal
  JAX's, so parity runs use ``dropout=0``;
- the residual stream is in the compute dtype; logits are a
  compute-dtype product with the tied embedding, cast to f32.

Tensor parallelism (:meth:`GPT2LM.tensor_parallel`, the collective
backend's ``--model-axes tp=N``): given the pieces
:func:`~consensusml_tpu_torch.parallel.sharding.gpt2_tp_rules` cuts (the
fused ``qkv`` and ``out`` on the heads dim, ``mlp_in`` by column and
``mlp_out`` by row, ``wte``/``wpe`` on hidden), the full forward runs
the logical program on ``H/tp`` heads a rank: each block's input enters
the split products by ``copy_to``, the ``out`` and ``mlp_out`` partial
sums leave by ``reduce_from`` (f32 sums) before their replicated bias, and
the embedding tables are gathered whole (``gather_to``) for the lookup and
the tied head, which every rank computes alike.

Paths: the full forward (training, with autograd through the flash
kernels), the prefill ``return_kv`` forward, the paged single-token
decode step (``kv_cache`` + ``block_table``, ``positions`` ``(B,)``) and
the paged window (``positions`` ``(B, W)``: speculative decode's verify,
the prefix cache's suffix prefill), both of which update the pages in
place. The reference's per-slot cache path is not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from consensusml_tpu_torch.device import resolve_device
from consensusml_tpu_torch.models.attention import (
    dot_product_attention,
    paged_update_kv_cache,
    paged_update_kv_cache_window,
)
from consensusml_tpu_torch.models.fused_ln import FusedLayerNorm
from consensusml_tpu_torch.models.paged_attention import (
    fused_paged_attention,
    fused_paged_attention_window,
    resolve_attention_impl,
)
from consensusml_tpu_torch.parallel.axis import copy_to, gather_to, reduce_from

__all__ = ["NORM_IMPLS", "GPT2Config", "GPT2LM", "gpt2_loss_fn"]

NORM_IMPLS = ("flax", "pallas", "jnp")


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """GPT-2-medium by default (24 layers, hidden 1024, 16 heads), dropout
    0.1 as in the reference. ``norm_impl`` (one of :data:`NORM_IMPLS`)
    picks the LayerNorm: flax's, or the fused kernels."""

    vocab_size: int = 50257
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    max_len: int = 1024
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    norm_impl: str = "flax"

    def __post_init__(self):
        if self.norm_impl not in NORM_IMPLS:
            raise ValueError(f"unknown norm_impl {self.norm_impl!r} (one of {NORM_IMPLS})")

    @property
    def mlp_dim(self) -> int:
        return 4 * self.hidden

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def dropout(x: torch.Tensor, rate: float, deterministic: bool, generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scale kept
    values by ``1 / (1 - rate)``, zero the rest."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator (deterministic=False)")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 in, f32 out."""

    def __init__(self, features: int, device=None, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


def _layer_norm(config: GPT2Config, device) -> nn.Module:
    """``ln_1``/``ln_2``/``ln_f``: flax's LayerNorm (f32 out) or the fused
    one, whose output is the compute dtype (it feeds a matmul in that
    dtype: the same numbers as f32 out then cast)."""
    if config.norm_impl == "flax":
        return LayerNorm(config.hidden, device)
    return FusedLayerNorm(config.hidden, out_dtype=config.dtype, impl=config.norm_impl, device=device)


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral`` with ``dtype``: ``x @ kernel`` then
    ``+ bias``, both cast to ``dtype``. ``kernel`` has flax's shape
    ``in_shape + out_shape`` and is applied as its ``(prod(in),
    prod(out))`` view; ``x``'s last axis holds the ``prod(in)`` inputs."""

    def __init__(self, in_shape: tuple, out_shape: tuple, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.in_dims = len(in_shape)
        self.kernel = nn.Parameter(
            torch.empty(*in_shape, *out_shape, dtype=torch.float32, device=device)
        )
        self.bias = nn.Parameter(torch.zeros(*out_shape, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, reduce=None) -> torch.Tensor:
        """``reduce`` (a model-parallel axis): the kernel is a row piece,
        and the product's partial sums are reduced over the axis before the
        bias is added."""
        # (prod(in), prod(out)) of the kernel given, which under tensor
        # parallelism is this rank's piece
        kernel = self.kernel.to(self.dtype).reshape(-1, math.prod(self.kernel.shape[self.in_dims:]))
        y = x.to(self.dtype) @ kernel
        if reduce is not None:
            y = reduce_from(y, reduce)
        return y + self.bias.to(self.dtype).reshape(-1)


class Embed(nn.Module):
    """flax ``nn.Embed`` with ``dtype``: the f32 table is cast to ``dtype``
    before the lookup and before :meth:`attend` (the tied head), each on
    its own, as flax casts it in each call."""

    def __init__(self, num: int, features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features, dtype=torch.float32, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding.to(self.dtype)[ids]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.embedding.to(self.dtype).T

    def table(self, tp) -> torch.Tensor:
        """The table in the compute dtype, gathered whole over the
        model-parallel axis ``tp`` from its pieces on the feature dim."""
        return gather_to(self.embedding.to(self.dtype), tp, dim=1)


class DecoderBlock(nn.Module):
    tp = None  # the model-parallel Axis under tensor parallelism (GPT2LM.tensor_parallel)

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        c = self.config = config
        dh = c.head_dim
        self.ln_1 = _layer_norm(c, device)
        self.qkv = Dense((c.hidden,), (c.heads, 3 * dh), c.dtype, device)
        self.out = Dense((c.heads, dh), (c.hidden,), c.dtype, device)
        self.ln_2 = _layer_norm(c, device)
        self.mlp_in = Dense((c.hidden,), (c.mlp_dim,), c.dtype, device)
        self.mlp_out = Dense((c.mlp_dim,), (c.hidden,), c.dtype, device)

    def forward(self, x, *, cache=None, positions=None, block_table=None, attn_impl="auto",
                deterministic=True, generator=None):
        """``(x, kv)``: ``kv`` is this layer's ``(k, v)`` (B, S, H, D) on
        the full/prefill path, ``None`` on the paged paths (whose K/V go
        into ``cache`` in place: one token a slot at ``positions`` (B,),
        or a window at ``positions`` (B, S))."""
        c = self.config
        attn_impl = resolve_attention_impl(attn_impl, x.device)
        b, s, _ = x.shape
        dh = c.head_dim
        heads = self.qkv.kernel.shape[1]  # this rank's heads (all of them without tensor parallelism)
        qkv = self.qkv(copy_to(self.ln_1(x), self.tp)).view(b, s, heads, 3 * dh)
        q, k, v = (t.contiguous() for t in qkv.split(dh, dim=-1))
        kv = None
        if cache is not None and positions.dim() == 2:
            paged_update_kv_cache_window(cache, k, v, block_table, positions)
            attn = fused_paged_attention_window(
                q, cache["k"], cache["v"], block_table,
                positions=positions, dtype=c.dtype, impl=attn_impl,
            )
        elif cache is not None:
            lengths = paged_update_kv_cache(cache, k, v, block_table, positions)
            attn = fused_paged_attention(
                q, cache["k"], cache["v"], block_table,
                lengths=lengths, dtype=c.dtype, impl=attn_impl,
            )
        else:
            attn = dot_product_attention(
                q, k, v, causal=True, dtype=c.dtype, use_kernel=attn_impl == "cuda"
            )
            kv = (k, v)
        attn = self.out(attn.reshape(b, s, heads * dh), reduce=self.tp)
        x = x + dropout(attn, c.dropout, deterministic, generator)
        y = F.gelu(self.mlp_in(copy_to(self.ln_2(x), self.tp)), approximate="tanh")
        y = self.mlp_out(y, reduce=self.tp)
        return x + dropout(y, c.dropout, deterministic, generator), kv


class GPT2LM(nn.Module):
    """GPT-2 causal LM. Parameters are created on ``device`` (``None`` =
    the current CUDA device; raises without one) in f32 and left
    uninitialized: load a state dict (:func:`.convert.gpt2_from_flax`) or
    call :meth:`init_weights`. Blocks are the submodules ``h_0 .. h_{L-1}``,
    the reference's names."""

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = c = config
        self.wte = Embed(c.vocab_size, c.hidden, c.dtype, device)
        self.wpe = Embed(c.max_len, c.hidden, c.dtype, device)
        for i in range(c.layers):
            self.add_module(f"h_{i}", DecoderBlock(c, device))
        self.ln_f = _layer_norm(c, device)

    @property
    def blocks(self) -> list[DecoderBlock]:
        return [getattr(self, f"h_{i}") for i in range(self.config.layers)]

    tp = None

    def tensor_parallel(self, axis) -> "GPT2LM":
        """Run the full forward on the pieces ``gpt2_tp_rules`` cuts over
        the model-parallel :class:`~consensusml_tpu_torch.parallel.axis.
        Axis` ``axis`` (module docstring); the paged serving paths are not
        taken under it."""
        self.tp = axis
        for blk in self.blocks:
            blk.tp = axis
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> "GPT2LM":
        """Random weights N(0, std) from ``generator``, zero biases, unit
        LayerNorm scales."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
        return self

    @torch.no_grad()
    def to_compute_dtype(self) -> "GPT2LM":
        """Cast the Dense and embedding parameters to the compute dtype once
        (LayerNorm stays f32): the same values the per-op casts give, for
        inference without a cast per call. Training keeps f32 masters."""
        for mod in self.modules():
            if isinstance(mod, (Dense, Embed)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(mod.dtype)
        return self

    def forward(
        self,
        input_ids: torch.Tensor,  # (B, S) int
        *,
        positions: torch.Tensor | None = None,  # (B,) decode or (B, S) window positions
        kv_cache: list | None = None,
        block_table: torch.Tensor | None = None,
        return_kv: bool = False,
        attn_impl: str = "auto",
        deterministic: bool = True,
        generator: torch.Generator | None = None,
    ):
        """f32 logits ``(B, S, V)``.

        ``deterministic=False`` applies dropout with ``generator`` (on the
        input's device); the default runs without it, as inference does.

        ``return_kv=True`` (prefill) also returns each layer's ``(k, v)``.
        ``kv_cache`` (per-layer ``{"k", "v"}`` page pools) with
        ``block_table`` and ``positions`` runs one single-token decode
        step, writing this token's K/V into the pages in place; with 2-D
        ``positions`` ``(B, S)`` it runs an S-token window a slot (the
        verify of speculative decode, a prefix hit's suffix), each token at
        its own position: its K/V written first, then each query attends
        the cache up to its position. Positions past ``max_len`` (window
        rows near the cache's end) read the last position embedding and
        write through the caller's trash-padded table columns.
        ``attn_impl`` goes through
        :func:`.paged_attention.resolve_attention_impl`: ``"auto"`` is
        the CUDA kernels for CUDA tensors and their plain versions on the
        CPU; ``"torch"`` asks for the plain versions by name (paged
        attention on the decode path, flash attention for flash-sized
        prefill buckets).
        """
        c = self.config
        if kv_cache is not None and return_kv:
            raise ValueError("kv_cache (decode) and return_kv (prefill) are exclusive")
        if (kv_cache is None) != (block_table is None):
            raise ValueError("the paged decode step needs both kv_cache and block_table")
        b, s = input_ids.shape
        attn_impl = resolve_attention_impl(attn_impl, input_ids.device)
        multi = positions is not None and positions.dim() == 2
        if multi and kv_cache is None:
            raise ValueError("2-D positions (a window) need kv_cache and block_table")
        if kv_cache is not None and (positions is None or (s != 1 and not multi)):
            raise ValueError(
                f"decode steps are single-token with positions, got seq len {s} "
                "(a window needs 2-D positions)"
            )
        if positions is None:
            pos = torch.arange(s, device=input_ids.device)[None, :]
        else:
            pos = positions if multi else positions[:, None]
        if self.tp is not None and (kv_cache is not None or return_kv):
            raise NotImplementedError("the serving paths do not run under tensor parallelism")
        # clamp the table lookup only (raw positions drive scatter and
        # masks): PyTorch raises / device-asserts where JAX would clamp
        pos = torch.clamp(pos, max=c.max_len - 1)
        if self.tp is None:
            x = self.wte(input_ids) + self.wpe(pos)
        else:
            wte = self.wte.table(self.tp)
            x = wte[input_ids] + self.wpe.table(self.tp)[pos]
        x = dropout(x, c.dropout, deterministic, generator)
        kvs = []
        for i, blk in enumerate(self.blocks):
            x, kv = blk(
                x,
                cache=kv_cache[i] if kv_cache is not None else None,
                positions=positions,
                block_table=block_table,
                attn_impl=attn_impl,
                deterministic=deterministic,
                generator=generator,
            )
            kvs.append(kv)
        x = self.ln_f(x)
        logits = (self.wte.attend(x) if self.tp is None else x.to(c.dtype) @ wte.T).float()
        if return_kv:
            return logits, kvs
        return logits


def gpt2_loss_fn(model: GPT2LM, attn_impl: str = "auto"):
    """Next-token loss (the reference's ``gpt2_loss_fn``, dense-logits
    branch): ``loss_fn(params, model_state, batch, generator)`` runs
    ``model`` with ``params`` (one worker's tensors keyed by flax path)
    through :func:`torch.func.functional_call`, dropout on, and returns
    the f32 cross-entropy of predicting token t+1 over ``batch
    ["loss_mask"][:, 1:]`` (all ones by default). ``model`` only supplies
    the structure and may live on the ``meta`` device.

    The loss is taken over all S positions with the last one masked out,
    which is the reference's sum over the first S-1 (a slice of the f32
    logits would cost a copy of them)."""
    from consensusml_tpu_torch.models.losses import masked_lm_loss

    def loss_fn(params, model_state, batch, generator):
        ids = batch["input_ids"]
        b, s = ids.shape
        mask = batch.get("loss_mask")
        mask = torch.ones((b, s - 1), device=ids.device) if mask is None else mask[:, 1:]
        mask = torch.cat([mask.float(), torch.zeros((b, 1), device=ids.device)], dim=1)
        labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)
        logits = torch.func.functional_call(
            model, params, (ids,),
            {"deterministic": False, "generator": generator, "attn_impl": attn_impl},
        )
        return masked_lm_loss(logits, labels, mask), model_state

    return loss_fn
