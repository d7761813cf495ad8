"""Speculative decode: a draft proposes k tokens, ONE k+1-token verify.

Port of ``consensusml_tpu/serve/pool/spec.py``. Each engine round runs
two stages:

- **propose**: the DRAFT model (its own, smaller pages over the pool's
  block table) runs ``k + 1`` single-token decode steps, step ``i``
  writing its input's draft K/V at ``p0 + i`` and sampling proposal
  ``x_{i+1}`` under the plain path's ``SAMPLE_TAG`` key at that position
  (the last step exists for its write: after a fully accepted round the
  draft cache has no gap). It returns the proposals, the draft's
  probability of each, and its whole distributions;
- **verify**: ONE target forward over each slot's window ``[pending, x_1
  .. x_k]`` at positions ``p0 .. p0 + k`` (2-D ``positions``: the paged
  window, through the paged-attention kernel at ``W = k + 1``), then the
  acceptance on the device in one branchless pass: accept ``x_i`` iff
  ``u_i * q_i(x_i) <= p_i(x_i)`` (``u_i`` under ``ACCEPT_TAG`` at ``p0 + i
  - 1``); at the first rejection the replacement is drawn from the
  residual ``max(p_i - q_i, 0)`` renormalized (``RESIDUAL_TAG``); if all
  ``k`` survive, the bonus token from ``p_{k+1}`` under the ``SAMPLE_TAG``
  key plain decode would use at that position.

The emitted stream is distributed as target-only sampling, and when the
draft is the target every ratio is 1 and the stream is the plain path's
token for token (every draw reuses its keys). The host reads back three
small arrays and keeps its bookkeeping in plain integers: the accepted
prefix is committed by advancing ``next_pos``; rejected rows sit past the
committed length, masked, and the next window overwrites them. Window
positions past a slot's row go to the trash-padded table columns
(:func:`spec_table_cols`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from consensusml_tpu_torch.serve.sampling import (
    ACCEPT_TAG,
    RESIDUAL_TAG,
    SAMPLE_TAG,
    adjusted_probs,
    categorical_from_probs,
    sampling_uniforms,
)

__all__ = ["SpecConfig", "spec_table_cols", "make_draft_propose_fn", "make_verify_fn"]


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decode for :class:`~consensusml_tpu_torch.serve.Engine`:
    ``model`` is the draft causal LM (``GPT2LM`` or ``LlamaLM`` with its
    weights loaded, sharing the target's vocabulary), ``k`` the proposals
    a round (1 to ``k + 1`` tokens a lane a round)."""

    model: Any
    k: int = 4

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")


def spec_table_cols(blocks_per_slot: int, block_size: int, k: int) -> int:
    """Block-table width the speculative stages index: the real columns
    plus enough trash ones that the window's last position, ``max_len - 1
    + k``, still resolves."""
    return blocks_per_slot + (block_size - 1 + k) // block_size


def make_draft_propose_fn(draft_dm: Any, k: int, attn_impl: str = "auto") -> Callable:
    """``propose(draft_pages, block_table (S, cols), tokens (S,), positions
    (S,), temperature (S,), top_p (S,), seeds (S,))`` -> ``(proposals (S,
    k), q_sel (S, k), q_probs (S, k, V))``: ``k + 1`` draft decode steps,
    the pages updated in place (the reference's ``lax.scan`` is a loop)."""
    model = draft_dm.model

    @torch.inference_mode()
    def propose(draft_pages, block_table, tokens, positions, temperature, top_p, seeds):
        tok, pos = tokens, positions
        props, q_sel, q_probs = [], [], []
        for i in range(k + 1):
            logits = model(tok[:, None], positions=pos, kv_cache=draft_pages, block_table=block_table,
                           attn_impl=attn_impl)[:, 0]
            if i == k:
                break  # the write-only tail step: its sample is not used
            probs = adjusted_probs(logits, temperature, top_p)
            nxt = categorical_from_probs(sampling_uniforms(seeds, pos, SAMPLE_TAG, probs.shape[-1]), probs)
            props.append(nxt)
            q_sel.append(torch.gather(probs, 1, nxt.long()[:, None])[:, 0])
            q_probs.append(probs)
            tok, pos = nxt, pos + 1
        return torch.stack(props, 1), torch.stack(q_sel, 1), torch.stack(q_probs, 1)

    return propose


def make_verify_fn(dm: Any, k: int, attn_impl: str = "auto") -> Callable:
    """``verify(pages, block_table (S, cols), tokens (S,), proposals (S,
    k), q_sel (S, k), q_probs (S, k, V), positions (S,), temperature (S,),
    top_p (S,), seeds (S,))`` -> ``(n_accept (S,), final (S,), logits (S,
    k + 1, V))``: a lane emits ``x_1 .. x_{n_accept}`` then ``final`` (the
    residual replacement at the first rejected row, or the bonus draw)."""
    model = dm.model

    @torch.inference_mode()
    def verify(pages, block_table, tokens, proposals, q_sel, q_probs, positions, temperature, top_p, seeds):
        s = tokens.shape[0]
        window = torch.cat([tokens[:, None], proposals.to(tokens.dtype)], dim=1)
        pos = positions.long()[:, None] + torch.arange(k + 1, device=tokens.device)[None, :]
        logits = model(window, positions=pos, kv_cache=pages, block_table=block_table, attn_impl=attn_impl)
        vocab = logits.shape[-1]
        # the target's distributions for every window row, by the same
        # temperature / top-p transform the draft applied
        p_dist = adjusted_probs(logits, temperature[:, None], top_p[:, None])  # (S, k+1, V)
        p_sel = torch.gather(p_dist[:, :k], 2, proposals.long()[:, :, None])[:, :, 0]
        lane_seeds = seeds[:, None].expand(s, k)
        u = sampling_uniforms(lane_seeds, pos[:, :k], ACCEPT_TAG, 1)[..., 0]
        # accept x_i with probability min(1, p_i / q_i), without the
        # division: a draft equal to the target (q == p) always accepts
        accept = u * q_sel <= p_sel
        n_accept = torch.cumprod(accept.to(torch.int32), dim=1).sum(1)  # (S,) in [0, k]
        # rows < k draw from the residual max(p - q, 0) renormalized (p
        # itself where it is all zero, which a real rejection never
        # meets); row k draws the bonus from p_k under the plain key
        resid = torch.clamp(p_dist[:, :k] - q_probs, min=0.0)
        rsum = resid.sum(-1, keepdim=True)
        resid = torch.where(rsum > 0, resid / torch.clamp(rsum, min=1e-38), p_dist[:, :k])
        fall_rows = categorical_from_probs(sampling_uniforms(lane_seeds, pos[:, :k], RESIDUAL_TAG, vocab), resid)
        bonus = categorical_from_probs(sampling_uniforms(seeds, pos[:, k], SAMPLE_TAG, vocab), p_dist[:, k])
        fallback = torch.cat([fall_rows, bonus[:, None]], dim=1)
        final = torch.gather(fallback, 1, n_accept.long()[:, None])[:, 0]
        return n_accept.to(torch.int32), final.to(torch.int32), logits

    return verify
