"""Held-out evaluation of stacked workers and of their mean model (port
of ``consensusml_tpu/train/evaluate.py``).

The reference's parity condition is matching top-1 accuracy, and
decentralized training has W disagreeing replicas beside the consensus
model (the worker-mean parameters, what one would deploy), so both are
scored on the same batches; the gap between them closes as the consensus
error goes to zero.

Metric functions return SUMS, so results accumulate exactly across
batches: classification ``{"correct", "count"}``, causal LM ``{"nll",
"count"}`` (next-token), masked LM ``{"correct", "count", "nll"}`` over
the masked positions. :func:`evaluate` derives ``top1`` = correct / count
(the masked LM's masked-token accuracy) and ``nll`` = nll / count,
``ppl`` = exp(nll).

:func:`evaluate_collective` is the collective backend's: each rank holds
one worker, the mean model is the ranks' all-reduce mean, and every rank
gets the stacked :func:`evaluate`'s result.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from consensusml_tpu_torch.utils.tree import consensus_mean

__all__ = [
    "classification_eval_fn", "causal_lm_eval_fn", "mlm_eval_fn", "make_stacked_eval_step", "evaluate",
    "evaluate_collective",
]

EvalFn = Callable[[dict, dict, dict], dict[str, torch.Tensor]]


def classification_eval_fn(model, *, train_kwarg: bool = False) -> EvalFn:
    """Top-1 sums for image classifiers (the MLP, the ResNet): ``model``
    (structure only) run with one set of ``params`` and ``model_state``'s
    ``batch_stats``; ``train_kwarg=True`` passes ``train=False`` (a BN
    model then normalizes with its running statistics)."""

    def eval_fn(params, model_state, batch):
        tensors = {**params, **model_state.get("batch_stats", {})}
        kwargs = {"train": False} if train_kwarg else {}
        logits = functional_call(model, tensors, (batch["image"],), kwargs)
        pred = torch.argmax(logits.to(torch.float32), dim=-1)
        return {
            "correct": (pred == batch["label"]).to(torch.float32).sum(),
            "count": torch.tensor(float(pred.numel()), device=pred.device),
        }

    return eval_fn


def causal_lm_eval_fn(model, *, deterministic_kwarg: bool = True) -> EvalFn:
    """Next-token NLL sums for a causal LM, dropout off: GPT-2 takes
    ``deterministic=True``; ``deterministic_kwarg=False`` passes nothing,
    for a model without dropout (Llama), as the reference's flag does."""

    def eval_fn(params, model_state, batch):
        ids = batch["input_ids"]
        logits = functional_call(model, params, (ids,), {"deterministic": True} if deterministic_kwarg else {})
        logits = logits[:, :-1].to(torch.float32)
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1).long(),
                              reduction="none")
        return {"nll": nll.sum(), "count": torch.tensor(float(nll.numel()), device=nll.device)}

    return eval_fn


def mlm_eval_fn(model) -> EvalFn:
    """Masked-position accuracy and NLL sums for a BERT-style masked LM,
    dropout off (the reference's ``mlm_eval_fn``): ``correct`` (argmax =
    label where ``mlm_mask``), ``count`` (the masked positions) and ``nll``
    (their cross-entropy), each weighted by ``batch["mlm_mask"]``."""

    def eval_fn(params, model_state, batch):
        logits = functional_call(model, params, (batch["input_ids"],),
                                 {"attention_mask": batch.get("attention_mask"), "deterministic": True})
        logits = logits.to(torch.float32)
        labels = batch["labels"].long()
        mask = batch["mlm_mask"].to(torch.float32)
        pred = torch.argmax(logits, dim=-1)
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                              reduction="none").reshape(labels.shape)
        return {
            "correct": ((pred == labels).to(torch.float32) * mask).sum(),
            "count": mask.sum(),
            "nll": (nll * mask).sum(),
        }

    return eval_fn


def make_stacked_eval_step(eval_fn: EvalFn, frozen: dict | None = None):
    """``step(params, model_state, batch) -> (per_worker, mean_model)``:
    every replica of the stacked ``params``/``model_state`` (leading worker
    axis) and the worker-mean model (:func:`..utils.tree.consensus_mean`)
    score the same unstacked ``batch``; ``per_worker`` leaves carry the
    ``(W,)`` axis. Workers run one at a time (the reference vmaps). The
    ``frozen`` leaves (a LoRA run's shared base, held once) join every
    model's parameters as they are: the mean of W identical rows."""
    frozen = {} if frozen is None else frozen

    @torch.no_grad()
    def step(params, model_state, batch):
        world = next(iter(params.values())).shape[0]
        per = [
            eval_fn({**frozen, **{n: p[w] for n, p in params.items()}}, _worker(model_state, w), batch)
            for w in range(world)
        ]
        per = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        mean = eval_fn({**frozen, **consensus_mean(params)}, consensus_mean(model_state), batch)
        return per, mean

    return step


def _worker(tree: Any, w: int) -> Any:
    if isinstance(tree, dict):
        return {k: _worker(v, w) for k, v in tree.items()}
    return tree[w]


def _fetch(v: torch.Tensor) -> np.ndarray:
    return np.asarray(v.detach().to("cpu", torch.float64).numpy())


def _derive(sums: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    out = {}
    count = sums.get("count")
    if count is None:
        return dict(sums)
    if "correct" in sums:
        out["top1"] = sums["correct"] / np.maximum(count, 1.0)
    if "nll" in sums:
        out["nll"] = sums["nll"] / np.maximum(count, 1.0)
        out["ppl"] = np.exp(out["nll"])
    return out


def evaluate(eval_fn: EvalFn, state, batches: Iterable[dict]) -> dict[str, Any]:
    """Accumulate eval sums over ``batches`` (moved to the state's device)
    for the stacked train ``state`` (its frozen base, if any, read once)
    and derive the metrics::

        {"mean_model": {"top1": ..}, "per_worker": {"top1": array (W,)},
         "worker_mean": {"top1": ..}}   # scalar mean over workers
    """
    step = make_stacked_eval_step(eval_fn, getattr(state, "frozen", None))
    device = next(iter(state.params.values())).device
    tot_per = tot_mean = None
    for batch in batches:
        per, mean = step(state.params, state.model_state, {k: v.to(device) for k, v in batch.items()})
        per = {k: _fetch(v) for k, v in per.items()}
        mean = {k: _fetch(v) for k, v in mean.items()}
        if tot_per is None:
            tot_per, tot_mean = per, mean
        else:
            tot_per = {k: tot_per[k] + v for k, v in per.items()}
            tot_mean = {k: tot_mean[k] + v for k, v in mean.items()}
    if tot_per is None:
        raise ValueError("evaluate() got an empty batch iterator")
    per_metrics = _derive(tot_per)
    return {
        "mean_model": _derive(tot_mean),
        "per_worker": per_metrics,
        "worker_mean": {k: float(np.mean(v)) for k, v in per_metrics.items()},
    }


def evaluate_collective(eval_fn: EvalFn, state, batches: Iterable[dict], mesh) -> dict[str, Any]:
    """:func:`evaluate` on the collective backend, called by every rank with
    its own state (a stack of one worker) and the same ``batches``. The
    mean model is the all-reduce mean of the ranks' parameters and model
    state (f32 sums over the ranks, divided by the world size); rank 0
    scores it, each rank scores its own worker, and one all-reduce of a
    ``(world + 1, keys)`` table of f64 sums gives every rank the whole
    result, in :func:`evaluate`'s form."""
    from consensusml_tpu_torch.comm import collectives
    from consensusml_tpu_torch.utils import tree as T

    frozen = getattr(state, "frozen", None) or {}
    params = {n: p[0] for n, p in state.params.items()}
    ms_leaves, ms_spec = T.flatten(T.tree_map(lambda t: t[0], state.model_state))
    names = list(params)
    means = collectives.all_reduce_mean(list(params.values()) + ms_leaves, mesh)
    mean_params = dict(zip(names, means[: len(names)]))
    mean_state = T.unflatten(ms_spec, means[len(names):])
    own_state = T.unflatten(ms_spec, ms_leaves)
    device = mesh.device
    own = mean = None
    with torch.no_grad():
        for batch in batches:
            batch = {k: v.to(device) for k, v in batch.items()}
            got = {k: _fetch(v) for k, v in eval_fn({**frozen, **params}, own_state, batch).items()}
            own = got if own is None else {k: own[k] + v for k, v in got.items()}
            if mesh.rank == 0:
                got = {k: _fetch(v) for k, v in eval_fn({**frozen, **mean_params}, mean_state, batch).items()}
                mean = got if mean is None else {k: mean[k] + v for k, v in got.items()}
    if own is None:
        raise ValueError("evaluate_collective() got an empty batch iterator")
    keys = sorted(own)
    table = torch.zeros((mesh.world_size + 1, len(keys)), dtype=torch.float64, device=device)
    table[mesh.rank] = torch.tensor([float(own[k]) for k in keys], dtype=torch.float64)
    if mesh.rank == 0:
        table[-1] = torch.tensor([float(mean[k]) for k in keys], dtype=torch.float64)
    table = mesh.transport.all_reduce_sum([table])[0].cpu().numpy()
    per_metrics = _derive({k: table[:-1, i] for i, k in enumerate(keys)})
    return {
        "mean_model": _derive({k: table[-1, i] for i, k in enumerate(keys)}),
        "per_worker": per_metrics,
        "worker_mean": {k: float(np.mean(v)) for k, v in per_metrics.items()},
    }
