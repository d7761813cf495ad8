"""BERT encoder for masked-LM pretraining (port of
``consensusml_tpu/models/bert.py``).

Canonical BERT-base: 12 post-LN layers, hidden 768, 12 heads, tanh-GELU,
learned positions and token types, a tied MLM decoder with its own f32
bias. The modules mirror the flax tree one for one (module path = flax
path joined by dots, flax's shapes, f32 parameters), so a flax tree loads
with a flatten (:func:`.convert.bert_from_flax`) and the gossip's bucket
layout is the reference's. The reference's numerics:

- ``qkv`` is ``DenseGeneral((heads, 3 * d_head))``, kernel ``(hidden,
  heads, 3 * d_head)``: q, k and v are split per head on the last axis;
  ``out`` is ``DenseGeneral(hidden, axis=(-2, -1))``, kernel ``(heads,
  d_head, hidden)``. Dense layers cast input and parameters to the
  compute dtype and add the bias as a separate op
  (:class:`.gpt2.Dense`);
- the three embeddings are summed in the compute dtype (tok + pos rounded,
  then + type), then ``ln_emb``;
- post-LN: every LayerNorm is flax's with ``dtype=float32`` (epsilon
  1e-6, fast variance), so the residual stream is f32 after each; a bf16
  branch output is promoted when it is added to it;
- GELU is the tanh form (flax's ``nn.gelu`` default);
- the decoder is ``tok_emb.attend`` of the compute-dtype hidden state
  (compute-dtype logits) plus ``mlm_bias`` (f32): f32 logits;
- dropout at the embedding, after ``out`` and after ``mlp_out``, only
  with ``deterministic=False``, drawn from an explicit ``torch.Generator``;
- attention through :func:`.attention.dot_product_attention` with
  ``kv_mask=attention_mask``: dense up to S*T = 512^2 (the config's seq
  128), the flash kernels with their per-key mask above it on a CUDA
  tensor (``attn_impl="torch"``: their plain versions).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from consensusml_tpu_torch.device import resolve_device
from consensusml_tpu_torch.models.attention import dot_product_attention
from consensusml_tpu_torch.models.gpt2 import Dense, Embed, LayerNorm, dropout
from consensusml_tpu_torch.models.paged_attention import resolve_attention_impl

__all__ = ["BertConfig", "BertMLM", "bert_base", "bert_mlm_loss_fn"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT-base by default, as the reference's."""

    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def bert_base(device=None, **overrides) -> "BertMLM":
    """:class:`BertMLM` of ``BertConfig(**overrides)`` on ``device``."""
    return BertMLM(BertConfig(**overrides), device=device)


class EncoderLayer(nn.Module):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        c = self.config = config
        dh = c.head_dim
        self.qkv = Dense((c.hidden,), (c.heads, 3 * dh), c.dtype, device)
        self.out = Dense((c.heads, dh), (c.hidden,), c.dtype, device)
        self.ln_attn = LayerNorm(c.hidden, device)
        self.mlp_in = Dense((c.hidden,), (c.mlp_dim,), c.dtype, device)
        self.mlp_out = Dense((c.mlp_dim,), (c.hidden,), c.dtype, device)
        self.ln_mlp = LayerNorm(c.hidden, device)

    def forward(self, x, kv_mask, *, attn_impl: str, deterministic: bool, generator):
        c = self.config
        b, s, _ = x.shape
        dh = c.head_dim
        qkv = self.qkv(x).view(b, s, c.heads, 3 * dh)
        q, k, v = (t.contiguous() for t in qkv.split(dh, dim=-1))
        attn = dot_product_attention(q, k, v, kv_mask=kv_mask, dtype=c.dtype, use_kernel=attn_impl == "cuda")
        attn = self.out(attn.reshape(b, s, c.hidden))
        x = self.ln_attn(x + dropout(attn, c.dropout, deterministic, generator))
        y = F.gelu(self.mlp_in(x), approximate="tanh")
        y = self.mlp_out(y)
        return self.ln_mlp(x + dropout(y, c.dropout, deterministic, generator))


class BertMLM(nn.Module):
    """BERT encoder + tied-embedding MLM head: ``forward(input_ids,
    attention_mask=None, token_type_ids=None)`` gives f32 logits over the
    vocab at every position. Parameters are created on ``device`` (``None``
    = the current CUDA device; raises without one) in f32 and left
    uninitialized: load a state dict (:func:`.convert.bert_from_flax`) or
    pass them through ``torch.func.functional_call``. Layers are the
    submodules ``layer_0 .. layer_{L-1}``, the reference's names."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = c = config
        self.tok_emb = Embed(c.vocab_size, c.hidden, c.dtype, device)
        self.pos_emb = Embed(c.max_len, c.hidden, c.dtype, device)
        self.type_emb = Embed(c.type_vocab, c.hidden, c.dtype, device)
        self.ln_emb = LayerNorm(c.hidden, device)
        for i in range(c.layers):
            self.add_module(f"layer_{i}", EncoderLayer(c, device))
        self.mlm_dense = Dense((c.hidden,), (c.hidden,), c.dtype, device)
        self.mlm_ln = LayerNorm(c.hidden, device)
        self.mlm_bias = nn.Parameter(torch.zeros(c.vocab_size, dtype=torch.float32, device=device))

    @property
    def layers(self) -> list[EncoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.config.layers)]

    def forward(
        self,
        input_ids: torch.Tensor,  # (B, S) int
        attention_mask: torch.Tensor | None = None,  # (B, S), 1 = attend
        token_type_ids: torch.Tensor | None = None,
        *,
        attn_impl: str = "auto",
        deterministic: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """f32 logits ``(B, S, V)``. ``deterministic=False`` applies dropout
        with ``generator``. ``attn_impl`` (:func:`.paged_attention.
        resolve_attention_impl`): ``"auto"`` is the flash kernels for
        flash-sized CUDA inputs, ``"torch"`` their plain versions."""
        c = self.config
        attn_impl = resolve_attention_impl(attn_impl, input_ids.device)
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.tok_emb(input_ids) + self.pos_emb(pos)
        x = self.ln_emb(x + self.type_emb(token_type_ids))
        x = dropout(x, c.dropout, deterministic, generator)
        for layer in self.layers:
            x = layer(x, attention_mask, attn_impl=attn_impl, deterministic=deterministic, generator=generator)
        x = F.gelu(self.mlm_dense(x), approximate="tanh")
        x = self.mlm_ln(x)
        return self.tok_emb.attend(x) + self.mlm_bias


def bert_mlm_loss_fn(model: BertMLM, attn_impl: str = "auto"):
    """The reference's ``bert_mlm_loss_fn``: ``loss_fn(params, model_state,
    batch, generator)`` runs ``model`` (structure only; ``meta`` is fine)
    with ``params`` through :func:`torch.func.functional_call`, dropout
    on, and returns the f32 cross-entropy over the positions where
    ``batch["mlm_mask"]`` is 1 (``input_ids`` corrupted, ``labels`` the
    original ids, optional ``attention_mask``), with ``model_state``
    unchanged."""
    from consensusml_tpu_torch.models.losses import masked_lm_loss

    def loss_fn(params, model_state, batch, generator):
        logits = torch.func.functional_call(
            model, params, (batch["input_ids"],),
            {"attention_mask": batch.get("attention_mask"), "deterministic": False, "generator": generator,
             "attn_impl": attn_impl},
        )
        return masked_lm_loss(logits, batch["labels"], batch["mlm_mask"]), model_state

    return loss_fn
