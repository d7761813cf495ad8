"""Local-SGD training round on the simulated backend (port of
``consensusml_tpu/train/local_sgd.py``, the non-fault, non-overlap branch
of ``make_simulated_train_step``).

``loss_fn(params, model_state, batch, generator) -> (scalar loss,
model_state)`` is user code; ``params`` is a dict of one worker's
parameter tensors keyed by flax path (``"h_0.qkv.kernel"``), and
``generator`` is that worker's dropout stream. A round consumes a batch
of shape ``(W, H, B, ...)``: H local optimizer steps per worker, then one
gossip round over ``{"params": ..., "model_state": {}}`` (the
reference's gossiped tree, so the bucket layout is its), then the
consensus error of the mixed params.

Workers are the leading axis of every state tensor, but the inner loop
runs them ONE AT A TIME over views of the stacked tensors: the
reference's ``vmap`` over workers would hold every worker's activations
at once (about 40 GB for four GPT-2-medium workers at batch 8 x 1024),
where one worker's step needs about 10 GB. Parameters, Adam moments and
the counters are updated in place; the gossip round returns new
parameter tensors (views of its bucket buffers).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from consensusml_tpu_torch.comm import simulated
from consensusml_tpu_torch.consensus import ChocoState, ConsensusEngine, GossipConfig
from consensusml_tpu_torch.train.optim import Adam, AdamState

__all__ = ["LocalSGDConfig", "TrainState", "init_stacked_state", "make_simulated_train_step"]

LossFn = Callable[[dict, Any, dict, torch.Generator], tuple[torch.Tensor, Any]]


@dataclasses.dataclass
class TrainState:
    step: int  # outer-round counter (host)
    params: dict[str, torch.Tensor]  # stacked (W, ...) f32, flax paths
    opt_state: AdamState
    gossip: ChocoState | None
    generators: list[torch.Generator]  # per-worker dropout streams


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    """One decentralized round = H local steps + one gossip round."""

    gossip: GossipConfig
    optimizer: Adam
    h: int = 1

    def __post_init__(self):
        if self.h < 1:
            raise ValueError(f"h must be >= 1, got {self.h}")

    def engine(self) -> ConsensusEngine:
        return ConsensusEngine(self.gossip)


def _gossiped(params: dict) -> dict:
    """The tree that rides the gossip round, as in the reference."""
    return {"params": params, "model_state": {}}


def init_stacked_state(cfg: LocalSGDConfig, params: dict[str, torch.Tensor], world_size: int,
                       seed: int = 0) -> TrainState:
    """State from stacked ``(W, ...)`` initial parameters (each worker its
    own replica, as decentralized training starts from disagreeing ones).
    Worker ``r``'s dropout generator is seeded ``seed * 1000003 + r``."""
    for name, p in params.items():
        if p.shape[0] != world_size or p.dtype != torch.float32:
            raise ValueError(f"{name}: expected stacked f32 ({world_size}, ...), got {p.dtype} {tuple(p.shape)}")
    device = next(iter(params.values())).device
    gens = [torch.Generator(device=device).manual_seed(seed * 1000003 + r) for r in range(world_size)]
    return TrainState(
        step=0,
        params=params,
        opt_state=cfg.optimizer.init(params, world_size),
        gossip=cfg.engine().init_state(_gossiped(params), world_size=world_size),
        generators=gens,
    )


def worker_step(cfg: LocalSGDConfig, loss_fn: LossFn, state: TrainState, worker: int,
                batch: dict) -> torch.Tensor:
    """One local optimizer step of one worker on one microbatch, in place.
    Returns the loss (a 0-dim tensor on the device)."""
    views = {n: p[worker] for n, p in state.params.items()}
    leaves = {n: v.detach().requires_grad_(True) for n, v in views.items()}
    loss, _ = loss_fn(leaves, {}, batch, state.generators[worker])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    del leaves
    cfg.optimizer.update_(views, dict(zip(views, grads)), state.opt_state, worker)
    return loss.detach()


def make_simulated_train_step(cfg: LocalSGDConfig, loss_fn: LossFn):
    """``step(state, batch) -> (state, metrics)`` for stacked workers on one
    device: per worker (one at a time) H local steps, then one gossip round
    through the mixing matrix, then the consensus error. ``metrics``:
    ``loss`` (mean over workers of each worker's mean over its H steps),
    ``consensus_error``, and the host wall time of the inner loop and of
    the gossip round in ms (both end in a device synchronisation)."""
    engine = cfg.engine()
    w_mat = simulated.mixing_matrix(cfg.gossip.topology)

    def step(state: TrainState, batch: dict):
        ids = batch["input_ids"]
        world, h = ids.shape[0], ids.shape[1]
        if h != cfg.h:
            raise ValueError(
                f"batch inner-step axis is {h} but LocalSGDConfig.h={cfg.h}; each round "
                "batch must carry exactly h microbatches per worker"
            )
        device = next(iter(state.params.values())).device
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        per_worker = []
        for w in range(world):
            losses = [
                worker_step(cfg, loss_fn, state, w, {"input_ids": ids[w, i].to(device)})
                for i in range(h)
            ]
            per_worker.append(torch.stack(losses).mean())
        sync()
        t1 = time.perf_counter()
        mixed, state.gossip = engine.round_simulated(
            _gossiped(state.params), state.gossip, w_mat.to(device), step=state.step
        )
        state.params = mixed["params"]
        err = engine.consensus_error_simulated(state.params)
        sync()
        t2 = time.perf_counter()
        state.step += 1
        return state, {
            "loss": torch.stack(per_worker).mean(),
            "consensus_error": err,
            "inner_ms": 1e3 * (t1 - t0),
            "gossip_ms": 1e3 * (t2 - t1),
        }

    return step
