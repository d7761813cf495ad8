"""GPT-2 decoder for serving (port of ``consensusml_tpu/models/gpt2.py``).

Pre-LN transformer, learned positions, tanh-GELU, tied LM head — the
reference's architecture and numerics, written as ``nn.Module``s:

- LayerNorm is flax's: epsilon 1e-6, f32 math on the promoted input,
  fast variance ``E[x^2] - E[x]^2`` clipped at 0, f32 output;
- Dense layers cast their input to the compute dtype, multiply, then add
  the bias as a separate op (flax's two bf16 roundings, not a fused
  epilogue); weights and biases are stored in the compute dtype, which
  gives the same values as flax's per-op cast of f32 parameters;
- the residual stream is in the compute dtype; logits are a
  compute-dtype product with the tied embedding, cast to f32.

The qkv projection keeps flax's per-head layout: output feature
``h * 3 * d_head + j`` is head ``h``'s q (``j < d_head``), k, then v —
not a ``(Q | K | V)`` stack over all heads.

Three paths (the reference's slot-cache and verify-window paths wait for
later slices): the full forward, the prefill ``return_kv`` forward, and
the paged single-token decode step (``kv_cache`` + ``block_table``),
which updates the pages in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from consensusml_tpu_torch.device import resolve_device
from consensusml_tpu_torch.models.attention import (
    dot_product_attention,
    paged_update_kv_cache,
)
from consensusml_tpu_torch.models.paged_attention import (
    fused_paged_attention,
    resolve_attention_impl,
)

__all__ = ["GPT2Config", "GPT2LM"]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """GPT-2-medium by default (24 layers, hidden 1024, 16 heads). The
    reference's dropout is absent: the port serves, it does not train."""

    vocab_size: int = 50257
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    max_len: int = 1024
    dtype: torch.dtype = torch.bfloat16

    @property
    def mlp_dim(self) -> int:
        return 4 * self.hidden

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


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


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral`` with ``dtype``: ``x @ W`` then ``+ b``
    (``weight`` is ``(out, in)``, PyTorch's habit)."""

    def __init__(self, fan_in: int, fan_out: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(fan_out, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight) + self.bias


class DecoderBlock(nn.Module):
    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        c = self.config = config
        self.ln_1 = LayerNorm(c.hidden, device)
        self.qkv = Dense(c.hidden, 3 * c.hidden, c.dtype, device)
        self.out = Dense(c.hidden, c.hidden, c.dtype, device)
        self.ln_2 = LayerNorm(c.hidden, device)
        self.mlp_in = Dense(c.hidden, c.mlp_dim, c.dtype, device)
        self.mlp_out = Dense(c.mlp_dim, c.hidden, c.dtype, device)

    def forward(self, x, *, cache=None, positions=None, block_table=None, attn_impl="auto"):
        """``(x, kv)``: ``kv`` is this layer's ``(k, v)`` (B, S, H, D) on
        the full/prefill path, ``None`` on the paged decode path (whose
        K/V go into ``cache`` in place)."""
        c = self.config
        attn_impl = resolve_attention_impl(attn_impl, x.device)
        b, s, _ = x.shape
        dh = c.head_dim
        qkv = self.qkv(self.ln_1(x)).view(b, s, c.heads, 3 * dh)
        q, k, v = (t.contiguous() for t in qkv.split(dh, dim=-1))
        kv = None
        if cache is not None:
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
        x = x + self.out(attn.reshape(b, s, c.hidden))
        y = F.gelu(self.mlp_in(self.ln_2(x)), approximate="tanh")
        return x + self.mlp_out(y), kv


class GPT2LM(nn.Module):
    """GPT-2 causal LM. Parameters are created on ``device`` (``None`` =
    the current CUDA device; raises without one) and left uninitialized:
    load a state dict (:func:`.convert.gpt2_from_flax`) or call
    :meth:`init_weights`."""

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = c = config
        self.wte = nn.Parameter(torch.empty(c.vocab_size, c.hidden, dtype=c.dtype, device=device))
        self.wpe = nn.Parameter(torch.empty(c.max_len, c.hidden, dtype=c.dtype, device=device))
        self.h = nn.ModuleList(DecoderBlock(c, device) for _ in range(c.layers))
        self.ln_f = LayerNorm(c.hidden, device)

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

    def forward(
        self,
        input_ids: torch.Tensor,  # (B, S) int
        *,
        positions: torch.Tensor | None = None,  # (B,) decode positions
        kv_cache: list | None = None,
        block_table: torch.Tensor | None = None,
        return_kv: bool = False,
        attn_impl: str = "auto",
    ):
        """f32 logits ``(B, S, V)``.

        ``return_kv=True`` (prefill) also returns each layer's ``(k, v)``.
        ``kv_cache`` (per-layer ``{"k", "v"}`` page pools) with
        ``block_table`` and ``positions`` runs one single-token decode
        step, writing this token's K/V into the pages in place.
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
        if kv_cache is not None and (s != 1 or positions is None):
            raise ValueError(f"decode steps are single-token with positions, got seq len {s}")
        pos = (
            torch.arange(s, device=input_ids.device)[None, :]
            if positions is None
            else positions[:, None]
        )
        # clamp the table lookup only (raw positions drive scatter and
        # masks): PyTorch raises / device-asserts where JAX would clamp
        x = self.wte[input_ids] + self.wpe[torch.clamp(pos, max=c.max_len - 1)]
        kvs = []
        for i, blk in enumerate(self.h):
            x, kv = blk(
                x,
                cache=kv_cache[i] if kv_cache is not None else None,
                positions=positions,
                block_table=block_table,
                attn_impl=attn_impl,
            )
            kvs.append(kv)
        x = self.ln_f(x)
        logits = F.linear(x.to(self.wte.dtype), self.wte).float()
        if return_kv:
            return logits, kvs
        return logits
