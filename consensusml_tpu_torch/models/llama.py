"""Llama-2 decoder with LoRA adapters (port of ``consensusml_tpu/models/llama.py``).

The reference's architecture and numerics: RMSNorm pre-norm, RoPE,
grouped-query attention, a SwiGLU MLP and an untied LM head, with
:class:`LoRADense` projections for q, k, v and o when ``lora_rank > 0``.
The modules mirror the flax tree one for one (module path = flax path
joined by dots, flax's shapes, f32 parameters: ``layer_0.q_proj.base.kernel``,
``layer_0.q_proj.lora_a``, ``layer_0.attn_norm.scale``, ``tok_emb.embedding``,
``lm_head.kernel``), so a flax tree loads with a flatten
(:func:`.convert.llama_from_flax`) and the gossip's bucket layout is the
reference's.

- Dense layers (``nn.Dense(use_bias=False, dtype)``) and the embedding
  cast input and parameters to the compute dtype per op, as flax does; a
  parameter already held in that dtype (the frozen base of a LoRA run,
  cast once: :func:`.convert.llama_frozen`) is then used as it is, which
  gives the same numbers;
- :class:`LoRADense` is ``x @ W + (alpha / rank) * ((x @ A) @ B)``, every
  product in the compute dtype, as written in the reference;
- :class:`RMSNorm` is f32 in, ``x.dtype`` out: ``x * rsqrt(mean(x^2) +
  eps) * scale`` with the compiled mean (the row sum times f32(1/H),
  :func:`~consensusml_tpu_torch.numerics.inv_rows`) and subnormals
  flushed as the reference's compiled program flushes them. It is an
  autograd function that saves only its input and the per-row rsqrt
  (the backward recomputes the rest), so a 7B step at 4096 tokens keeps
  no f32 copy of the residual stream per norm;
- RoPE (:func:`.attention.apply_rope`) on q and k, the keys and values
  repeated over their head groups (``repeat_interleave`` on the head
  axis, the reference's ``jnp.repeat``), then
  :func:`.attention.dot_product_attention` with ``causal=True``: dense up
  to S*T = 512^2, the flash kernels above it on a CUDA tensor (head dim
  128 at 7B);
- logits are the compute-dtype head product cast to f32.

Serving (the reference's paged hooks, as :class:`.gpt2.GPT2LM` takes
them): ``return_kv=True`` is the prefill, returning each layer's
pre-repeat ``(k, v)`` ``(B, S, Hkv, D)``; ``kv_cache`` (per-layer
``{"k", "v"}`` pools of pre-repeat ``(N, bs, Hkv, D)`` pages) with
``block_table`` and ``positions`` ``(B,)`` is one single-token decode
step: RoPE at each slot's position, this token's K/V written into the
pages in place (:func:`.attention.paged_update_kv_cache`), then
:func:`.paged_attention.fused_paged_attention`, which expands GQA inside
the kernel (no repeat of the pages). 2-D ``positions`` ``(B, S)`` run an
S-token window a slot the same way (speculative decode's verify, a prefix
hit's suffix: :func:`.attention.paged_update_kv_cache_window`, then
:func:`.paged_attention.fused_paged_attention_window`), each token
rotated at its own position.

Tensor parallelism (:meth:`LlamaLM.tensor_parallel`, the collective
backend's ``--model-axes tp=N``): given the pieces
:func:`~consensusml_tpu_torch.parallel.sharding.llama_tp_rules` cuts
(column-split q/k/v/gate/up and ``lm_head``, row-split o/down, ``tok_emb``
on hidden, each adapter following its base: ``lora_b`` of q/k/v by column,
``lora_a`` of o by row), the full forward runs the logical program: a
column-split product's input enters by ``copy_to`` (a column adapter's
``x @ lora_a``, whole on every rank, too), a row-split one's partial sums
leave by ``reduce_from`` (a row adapter's ``x @ lora_a`` is reduced before
``lora_b``, which is whole), and the embedding and head are gathered whole
(``gather_to``). A rank's query heads are ``H/tp``; its key/value heads
are its own pieces when the kv heads split evenly over the ranks, else
(``llama_tiny``'s 2 at tp 4) k and v are gathered whole and each rank
takes the kv head of each of its query heads.

Not ported, raising ``NotImplementedError``: the reference's per-slot
cache (``kv_cache`` without ``block_table``) and the chunked-vocab loss
(``loss_vocab_chunk > 0``, ``return_hidden``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from consensusml_tpu_torch.device import resolve_device
from consensusml_tpu_torch.models.attention import (
    apply_rope,
    dot_product_attention,
    paged_update_kv_cache,
    paged_update_kv_cache_window,
    rope_frequencies,
)
from consensusml_tpu_torch.models.gpt2 import Embed
from consensusml_tpu_torch.models.paged_attention import (
    fused_paged_attention,
    fused_paged_attention_window,
    resolve_attention_impl,
)
from consensusml_tpu_torch.numerics import ftz, inv_rows
from consensusml_tpu_torch.parallel.axis import copy_to, gather_to, reduce_from

__all__ = ["LlamaConfig", "LlamaLM", "LoRADense", "RMSNorm", "llama2_7b", "llama_tiny", "llama_loss_fn"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-2-7B by default, as the reference's."""

    vocab_size: int = 32000
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 32
    mlp_dim: int = 11008
    max_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    lora_rank: int = 0  # 0 = plain dense projections
    lora_alpha: float = 16.0
    loss_vocab_chunk: int = 0  # >0: the chunked-vocab loss, not ported yet
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def llama2_7b(device=None, **overrides) -> "LlamaLM":
    return LlamaLM(LlamaConfig(**overrides), device=device)


def llama_tiny(device=None, **overrides) -> "LlamaLM":
    """Test-scale Llama (the same code path, tiny dims; GQA: 4 heads, 2 kv heads)."""
    defaults = dict(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2, mlp_dim=128, max_len=128)
    defaults.update(overrides)
    return LlamaLM(LlamaConfig(**defaults), device=device)


class Dense(nn.Module):
    """flax ``nn.Dense(use_bias=False, dtype)``: ``x @ kernel``, both cast to
    ``dtype``; ``kernel`` is ``(in, out)``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, reduce=None) -> torch.Tensor:
        """``reduce`` (a model-parallel axis): the kernel is a row piece,
        its partial sums reduced over the axis."""
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if reduce is None else reduce_from(y, reduce)


class LoRADense(nn.Module):
    """The reference's ``LoRADense``: ``base`` (a :class:`Dense`) plus, at
    ``rank > 0``, the adapter ``(alpha / rank) * ((x @ lora_a) @ lora_b)``
    in the compute dtype (``lora_a`` ``(in, rank)``, ``lora_b`` ``(rank,
    out)``, f32 parameters)."""

    def __init__(self, in_features: int, features: int, rank: int, alpha: float, dtype: torch.dtype, device=None):
        super().__init__()
        self.rank, self.alpha, self.dtype = rank, alpha, dtype
        self.base = Dense(in_features, features, dtype, device)
        if rank > 0:
            self.lora_a = nn.Parameter(torch.empty(in_features, rank, dtype=torch.float32, device=device))
            self.lora_b = nn.Parameter(torch.empty(rank, features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, tp=None, row: bool = False) -> torch.Tensor:
        """``tp`` (a model-parallel axis): the column pieces (``row``
        false: ``base`` and ``lora_b`` by column) or the row pieces (``base``
        and ``lora_a`` by row) of the projection (module docstring)."""
        if tp is None:
            y = self.base(x)
        else:
            y = self.base(x, reduce=tp) if row else self.base(copy_to(x, tp))
        if self.rank > 0:
            u = x.to(self.dtype) @ self.lora_a.to(self.dtype)
            if tp is not None:
                u = reduce_from(u, tp) if row else copy_to(u, tp)
            y = y + (self.alpha / self.rank) * (u @ self.lora_b.to(self.dtype))
        return y


class _RMSNormFn(torch.autograd.Function):
    """y = x * r * scale with r = rsqrt(mean(x^2) + eps) per row, f32 math,
    subnormals flushed; saves x and r only."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        xf = ftz(x.float())
        ms = ftz(ftz(xf * xf).sum(-1, keepdim=True) * inv_rows(x.shape[-1]))
        r = torch.rsqrt(ms + eps)
        y = ftz(ftz(xf * r) * scale)
        ctx.save_for_backward(x, scale, r)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        # dL/dx_i = r g_i - x_i r^3 sum_j(g_j x_j) / n, g = dy * scale
        x, scale, r = ctx.saved_tensors
        n = x.shape[-1]
        xf = ftz(x.float())
        dyf = dy.float()
        g = dyf * scale
        dot = (g * xf).sum(-1, keepdim=True)
        dx = r * g - xf * (r * r * r) * (dot * inv_rows(n))
        dscale = (dyf * xf * r).reshape(-1, n).sum(0) if ctx.needs_input_grad[1] else None
        return dx.to(x.dtype), dscale, None


class RMSNorm(nn.Module):
    """The reference's ``RMSNorm``: f32 math, output in the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _RMSNormFn.apply(x, self.scale, self.eps)


class LlamaBlock(nn.Module):
    tp = None  # the model-parallel Axis under tensor parallelism (LlamaLM.tensor_parallel)

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = self.config = config
        d = c.head_dim
        proj = lambda i, o: LoRADense(i, o, c.lora_rank, c.lora_alpha, c.dtype, device)  # noqa: E731
        self.attn_norm = RMSNorm(c.hidden, c.norm_eps, device)
        self.q_proj = proj(c.hidden, c.heads * d)
        self.k_proj = proj(c.hidden, c.kv_heads * d)
        self.v_proj = proj(c.hidden, c.kv_heads * d)
        self.o_proj = proj(c.heads * d, c.hidden)
        self.mlp_norm = RMSNorm(c.hidden, c.norm_eps, device)
        self.gate_proj = Dense(c.hidden, c.mlp_dim, c.dtype, device)
        self.up_proj = Dense(c.hidden, c.mlp_dim, c.dtype, device)
        self.down_proj = Dense(c.mlp_dim, c.hidden, c.dtype, device)

    def forward(self, x: torch.Tensor, rope_table: torch.Tensor, *, cache=None, positions=None, block_table=None,
                return_kv: bool = False, attn_impl: str):
        """``(x, kv)``: ``kv`` is this layer's pre-repeat ``(k, v)`` with
        ``return_kv`` (the prefill), else ``None``; on the paged decode
        path (``cache``, ``block_table`` and ``positions`` ``(B,)``) this
        token's K/V go into the pages in place, on the window path
        (``positions`` ``(B, S)``) the window's."""
        c = self.config
        d = c.head_dim
        y = self.attn_norm(x)
        b, s, _ = y.shape
        multi = positions is not None and positions.dim() == 2
        # (B, 1): each slot's own position; (B, S): each window token's
        pos = None if positions is None else positions if multi else positions[:, None]
        tp = self.tp
        q, k, v = self.q_proj(y, tp), self.k_proj(y, tp), self.v_proj(y, tp)
        # this rank's heads (all of them without tensor parallelism)
        heads, kv_heads = q.shape[-1] // d, k.shape[-1] // d
        pick = None
        if tp is not None and c.kv_heads % tp.size:  # k and v whole, each query head's kv head picked
            k, v = (copy_to(gather_to(t, tp, -1), tp) for t in (k, v))
            kv_heads = c.kv_heads
            rep = c.heads // c.kv_heads
            pick = torch.tensor([(tp.index * heads + i) // rep for i in range(heads)], device=q.device)
        q = apply_rope(q.view(b, s, heads, d), rope_table, pos)
        k = apply_rope(k.view(b, s, kv_heads, d), rope_table, pos)
        v = v.view(b, s, kv_heads, d)
        kv = None
        if cache is not None and multi:
            paged_update_kv_cache_window(cache, k, v, block_table, positions)
            attn = fused_paged_attention_window(q, cache["k"], cache["v"], block_table, positions=positions,
                                                dtype=c.dtype, impl=attn_impl)
        elif cache is not None:
            # the pages hold pre-repeat (kv_heads) rows; the kernel repeats
            # them onto the query heads as it reads them
            lengths = paged_update_kv_cache(cache, k, v, block_table, positions)
            attn = fused_paged_attention(q, cache["k"], cache["v"], block_table, lengths=lengths, dtype=c.dtype,
                                         impl=attn_impl)
        else:
            if return_kv:
                kv = (k, v)  # pre-repeat, for the prefill's page insertion
            if pick is not None:
                k, v = k.index_select(2, pick), v.index_select(2, pick)
            elif heads != kv_heads:  # grouped-query attention
                k, v = k.repeat_interleave(heads // kv_heads, dim=2), v.repeat_interleave(heads // kv_heads, dim=2)
            attn = dot_product_attention(q, k, v, causal=True, dtype=c.dtype, use_kernel=attn_impl == "cuda")
        x = x + self.o_proj(attn.reshape(b, s, heads * d), tp, row=True)
        y = copy_to(self.mlp_norm(x), tp)
        return x + self.down_proj(F.silu(self.gate_proj(y)) * self.up_proj(y), reduce=tp), kv


class LlamaLM(nn.Module):
    """Llama causal LM: ``forward(input_ids)`` gives f32 logits ``(B, S,
    V)``. Parameters are created on ``device`` (``None`` = the current
    CUDA device; raises without one) in f32 and left uninitialized: pass
    them through ``torch.func.functional_call`` (the trainer does, with
    the frozen base and the worker's adapters) or load a state dict.
    Layers are the submodules ``layer_0 .. layer_{L-1}``, the reference's
    names."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = c = config
        self.tok_emb = Embed(c.vocab_size, c.hidden, c.dtype, device)
        for i in range(c.layers):
            self.add_module(f"layer_{i}", LlamaBlock(c, device))
        self.final_norm = RMSNorm(c.hidden, c.norm_eps, device)
        self.lm_head = Dense(c.hidden, c.vocab_size, c.dtype, device)

    @property
    def layers(self) -> list[LlamaBlock]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.layers)]

    tp = None

    def tensor_parallel(self, axis) -> "LlamaLM":
        """Run the full forward on the pieces ``llama_tp_rules`` cuts over
        the model-parallel :class:`~consensusml_tpu_torch.parallel.axis.
        Axis` ``axis`` (module docstring); the serving paths are not taken
        under it."""
        self.tp = axis
        for layer in self.layers:
            layer.tp = axis
        return self

    @torch.no_grad()
    def to_compute_dtype(self) -> "LlamaLM":
        """Cast the Dense, LoRA adapter and embedding parameters to the
        compute dtype once (RMSNorm scales stay f32): the same values the
        per-op casts give, for inference without a cast per call (the
        serving engine's contract). Training keeps f32 masters."""
        for mod in self.modules():
            if isinstance(mod, (Dense, LoRADense, Embed)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(mod.dtype)
        return self

    def forward(
        self,
        input_ids: torch.Tensor,  # (B, S) int
        *,
        attn_impl: str = "auto",
        positions: torch.Tensor | None = None,  # (B,) decode or (B, S) window positions
        kv_cache: list | None = None,
        block_table: torch.Tensor | None = None,
        return_kv: bool = False,
        return_hidden: bool = False,
    ):
        """f32 logits ``(B, S, V)``. ``attn_impl`` (:func:`.paged_attention.
        resolve_attention_impl`): ``"auto"`` is the CUDA kernels for CUDA
        tensors (flash for flash-sized prefills, paged attention on the
        decode step) and their plain versions on the CPU; ``"torch"`` asks
        for the plain versions by name.

        ``return_kv=True`` (prefill) also returns each layer's pre-repeat
        ``(k, v)``. ``kv_cache`` (per-layer ``{"k", "v"}`` page pools) with
        ``block_table`` and ``positions`` runs one single-token decode
        step, writing this token's K/V into the pages in place; 2-D
        ``positions`` ``(B, S)`` run an S-token window a slot (the verify,
        a prefix hit's suffix). Raises as the reference does on a decode
        step that also asks for the prefill's K/V, a ``block_table``
        without ``kv_cache``, a decode step of more than one token with 1-D
        positions and 2-D positions without the pages."""
        c = self.config
        if kv_cache is not None and return_kv:
            raise ValueError("kv_cache (decode) and return_kv (prefill) are exclusive")
        if block_table is not None and kv_cache is None:
            raise ValueError("block_table requires kv_cache (paged decode)")
        multi = positions is not None and positions.dim() == 2
        if kv_cache is not None and block_table is None:
            raise NotImplementedError("the per-slot cache (kv_cache without block_table) is not ported yet")
        if multi and kv_cache is None:
            raise ValueError("2-D positions (a window) need kv_cache and block_table")
        if kv_cache is not None and (positions is None or (input_ids.shape[1] != 1 and not multi)):
            raise ValueError(
                f"decode steps are single-token with positions, got seq len {input_ids.shape[1]}"
                + ("" if positions is not None else " and no positions") + " (a window needs 2-D positions)"
            )
        if return_hidden:
            raise NotImplementedError("the chunked-vocab loss path (return_hidden) is not ported yet")
        attn_impl = resolve_attention_impl(attn_impl, input_ids.device)
        if self.tp is not None and (kv_cache is not None or return_kv):
            raise NotImplementedError("the serving paths do not run under tensor parallelism")
        x = self.tok_emb(input_ids) if self.tp is None else self.tok_emb.table(self.tp)[input_ids]
        table = rope_frequencies(c.head_dim, c.max_len, c.rope_theta, device=input_ids.device)
        kvs = []
        for i, layer in enumerate(self.layers):
            x, kv = layer(x, table, cache=None if kv_cache is None else kv_cache[i], positions=positions,
                          block_table=block_table, return_kv=return_kv, attn_impl=attn_impl)
            kvs.append(kv)
        if self.tp is None:
            logits = self.lm_head(self.final_norm(x)).float()
        else:
            head = gather_to(self.lm_head.kernel.to(c.dtype), self.tp, dim=1)
            logits = (self.final_norm(x).to(c.dtype) @ head).float()
        if return_kv:
            return logits, kvs
        return logits


def llama_loss_fn(model: LlamaLM, attn_impl: str = "auto"):
    """The reference's ``llama_loss_fn`` on its dense loss:
    ``loss_fn(params, model_state, batch, generator)`` runs ``model``
    (structure only; ``meta`` is fine) with ``params`` (the frozen base
    and one worker's adapters, keyed by flax path) and returns the f32
    cross-entropy of predicting token t+1 over ``batch["loss_mask"][:,
    1:]`` (all ones by default), with ``model_state`` unchanged; the
    model has no dropout, so ``generator`` is unused. ``loss_fn.count(batch)``
    is that mask's sum, the loss's divisor, by which a trainer weights
    micro-batches. ``loss_vocab_chunk > 0`` raises ``NotImplementedError``."""
    from consensusml_tpu_torch.models.losses import masked_lm_loss

    if model.config.loss_vocab_chunk > 0:
        raise NotImplementedError("the chunked-vocab loss (loss_vocab_chunk > 0) is not ported yet")

    def shifted_mask(batch):
        ids = batch["input_ids"]
        mask = batch.get("loss_mask")
        if mask is None:
            return torch.ones((ids.shape[0], ids.shape[1] - 1), device=ids.device)
        return mask[:, 1:].float()

    def loss_fn(params, model_state, batch, generator):
        ids = batch["input_ids"]
        b = ids.shape[0]
        # the loss over all S positions with the last masked out: the
        # reference's sum over the first S - 1, without a copy of the logits
        mask = torch.cat([shifted_mask(batch), torch.zeros((b, 1), device=ids.device)], dim=1)
        labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)
        logits = torch.func.functional_call(model, params, (ids,), {"attn_impl": attn_impl})
        return masked_lm_loss(logits, labels, mask), model_state

    loss_fn.count = lambda batch: shifted_mask(batch).sum()
    return loss_fn
