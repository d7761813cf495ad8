"""Local-SGD training rounds (port of ``consensusml_tpu/train/local_sgd.py``:
``make_simulated_train_step`` and ``make_collective_train_step``, faults,
overlap gossip and the SlowMo outer step included).

``loss_fn(params, model_state, batch, generator) -> (scalar loss,
model_state)`` is user code; ``params`` is a dict of one worker's
parameter tensors keyed by flax path (``"h_0.qkv.kernel"``),
``model_state`` that worker's non-trained state (``{}``, or ResNet's
``{"batch_stats": {path: tensor}}``; the loss returns its new value), and
``generator`` is that worker's dropout stream. A round consumes a batch
dict whose every leaf is ``(W, H, B, ...)`` (``input_ids``, or ``image``
and ``label``): H local optimizer steps per worker, then one gossip
round over ``{"params": ..., "model_state": ...}`` (the reference's
gossiped tree, so the bucket layout is its), then the consensus error of
the mixed params.

Workers are the leading axis of every state tensor, but the inner loop
runs them ONE AT A TIME over views of the stacked tensors: the
reference's ``vmap`` over workers would hold every worker's activations
at once (about 40 GB for four GPT-2-medium workers at batch 8 x 1024),
where one worker's step needs about 10 GB. Parameters, model state,
optimizer state and counters are updated in place; the gossip round
returns new parameter and model-state tensors (views of its bucket
buffers).

A frozen base (a LoRA run's: ``llama_lora``) is held ONCE, unstacked,
in ``TrainState.frozen``: leaves that are not trained, not gossiped and
the same on every worker. Every worker's loss reads them beside its own
stacked leaves (``{**frozen, **worker_params}``), no gradient is taken
of them, and nothing stacks them: the gossip round and the consensus
error see the stacked tree only (a frozen leaf's term in the reference's
consensus error is W identical rows, zero up to the rounding of their
mean). A worker step takes gradients only of the leaves its optimizer
trains (``optimizer.trains(name)``), and with ``LocalSGDConfig.micro_batch``
splits its batch into micro-batches: the step's gradient is the sum of
theirs, each weighted by its share of the loss's divisor
(``loss_fn.count``), then one optimizer step, the reference's one-batch
gradient in another rounding order.

Overlap gossip (``cfg.gossip.overlap``, combine-then-adapt): a round
adds the queued correction to the params (``z``), computes the next one
from ``z``, measures the consensus error on ``z``, then runs the local
steps on ``z``. On the collective backend the correction's exchange is
posted before the local steps and finished after them
(:meth:`~consensusml_tpu_torch.consensus.ConsensusEngine.
correction_collective_start`), so its bytes move while the rank (or, on
a shared card, every rank in turn) computes.

SlowMo (``cfg.outer``, ``train/outer.py``): after the gossip round, and
before the consensus error is measured, every worker's mixed parameters
take one slow-momentum step from its outer point
(``TrainState.outer``), on both backends, after a fault rollback too.
Overlap gossip with SlowMo is refused, as in the reference: SlowMo steps
on the round's mixed parameters, which overlap gossip never forms.

Faults (``cfg.gossip.faults``, ``consensus/faults.py``): after a
worker's H local steps its loss, parameters and model state are checked
for finiteness on the device (one read a worker); a worker that failed
is rolled back to the rows it held before its steps (parameters, model
state and optimizer state, snapshotted just before them) and is dead for
the round. Its injected flag is the next draw of its fault generator
(``TrainState.fault_generators``), or row ``i`` of the simulated step's
``alive=`` mask (the reference's ``external_alive`` path), and the
round's mask is ``inject * ok``. The loss is averaged over the workers
kept; the metrics add ``alive_frac`` and ``alive_mask``.

The collective backend (:func:`make_collective_train_step`) runs ONE
worker per process: :func:`init_state` holds that worker's tensors as a
stack of one (so :func:`worker_step` and the optimizers run unchanged),
its CHOCO state per worker, and its dropout generator, seeded as the
simulated backend's worker ``rank``. Fed row ``rank`` of the simulated
backend's stacked batch (:func:`rank_batch`), the two backends start and
step identically.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from consensusml_tpu_torch.comm import collectives, simulated
from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
from consensusml_tpu_torch.consensus.faults import draw_alive, fault_generator, tree_all_finite
from consensusml_tpu_torch.train.outer import SlowMoConfig, slowmo_init, slowmo_update_
from consensusml_tpu_torch.utils import tree as T

__all__ = [
    "LocalSGDConfig", "TrainState", "init_stacked_state", "init_state", "worker_generator", "rank_batch",
    "worker_grads", "local_steps", "make_simulated_train_step", "make_collective_train_step",
]

LossFn = Callable[[dict, Any, dict, torch.Generator], tuple[torch.Tensor, Any]]


@dataclasses.dataclass
class TrainState:
    step: int  # outer-round counter (host)
    params: dict[str, torch.Tensor]  # stacked (W, ...) f32, flax paths
    model_state: dict  # stacked (W, ...) f32 leaves: {} or {"batch_stats": {path: ...}}
    opt_state: Any  # the optimizer's, stacked (AdamState, SGDState)
    gossip: Any  # the engine's: ChocoState, PushSumState, OverlapState or None
    generators: list[torch.Generator]  # per-worker dropout streams
    frozen: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)  # shared, unstacked, never trained
    # per-worker host streams of injected faults (with cfg.gossip.faults)
    fault_generators: list[torch.Generator] = dataclasses.field(default_factory=list)
    outer: Any = None  # SlowMo's {"x", "u"} (stacked f32, like params) with cfg.outer


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    """One decentralized round = H local steps + one gossip round (+ an
    optional SlowMo slow-momentum step on the mixed params)."""

    gossip: GossipConfig
    optimizer: Any  # init(params, world_size), update_(params, grads, state, worker), trains(name)
    h: int = 1
    outer: SlowMoConfig | None = None  # None: the mixed params are used as they are
    # rows of a worker's batch that one forward and backward take at once
    # (0: the whole batch); the step's gradient is still the whole batch's
    micro_batch: int = 0
    # the gossip wire's bucket cap, overriding gossip.bucket_bytes unless
    # "inherit" (0 or None: the per-leaf wire)
    bucket_bytes: int | None | str = "inherit"

    def __post_init__(self):
        if self.bucket_bytes != "inherit":
            object.__setattr__(self, "gossip", dataclasses.replace(self.gossip, bucket_bytes=self.bucket_bytes or None))
        if self.h < 1:
            raise ValueError(f"h must be >= 1, got {self.h}")
        if self.micro_batch < 0:
            raise ValueError(f"micro_batch must be >= 0, got {self.micro_batch}")
        if self.gossip.overlap and self.outer is not None:
            raise NotImplementedError(
                "overlap gossip + SlowMo is not supported: SlowMo's slow momentum steps on the same-round "
                "mixed params, which overlap mode never materializes"
            )

    def engine(self) -> ConsensusEngine:
        return ConsensusEngine(self.gossip)


def _gossiped(params: dict, model_state: dict) -> dict:
    """The tree that rides the gossip round, as in the reference: weights
    and BN-style statistics."""
    return {"params": params, "model_state": model_state}


def _check_frozen(params: dict, frozen: dict | None) -> dict:
    frozen = {} if frozen is None else frozen
    both = sorted(set(params) & set(frozen))
    if both:
        raise ValueError(f"leaves both stacked and frozen: {both[:4]}")
    return frozen


def init_stacked_state(cfg: LocalSGDConfig, params: dict[str, torch.Tensor], world_size: int,
                       seed: int = 0, model_state: dict | None = None,
                       frozen: dict[str, torch.Tensor] | None = None) -> TrainState:
    """State from stacked ``(W, ...)`` initial parameters and model state
    (each worker its own replica, as decentralized training starts from
    disagreeing ones) and, with ``frozen``, the shared base every worker's
    loss reads, held once as given (any dtype, no worker axis). Worker
    ``r``'s dropout generator is seeded ``seed * 1000003 + r``."""
    model_state = {} if model_state is None else model_state
    frozen = _check_frozen(params, frozen)
    for path, p in [((n,), p) for n, p in params.items()] + T.flatten_with_paths(model_state):
        if p.shape[0] != world_size or p.dtype != torch.float32:
            raise ValueError(
                f"{'.'.join(map(str, path))}: expected stacked f32 ({world_size}, ...), got {p.dtype} {tuple(p.shape)}"
            )
    device = next(iter(params.values())).device
    gens = [worker_generator(device, seed, r) for r in range(world_size)]
    return TrainState(
        step=0,
        params=params,
        model_state=model_state,
        opt_state=cfg.optimizer.init(params, world_size),
        gossip=cfg.engine().init_state(_gossiped(params, model_state), world_size=world_size),
        generators=gens,
        frozen=frozen,
        fault_generators=([fault_generator(seed, r) for r in range(world_size)]
                          if cfg.gossip.faults is not None else []),
        outer=slowmo_init(params) if cfg.outer is not None else None,
    )


def worker_generator(device, seed: int, rank: int) -> torch.Generator:
    """Worker ``rank``'s dropout generator on ``device`` for run ``seed``:
    the same bits on both backends."""
    return torch.Generator(device=device).manual_seed(seed * 1000003 + rank)


def init_state(cfg: LocalSGDConfig, params: dict[str, torch.Tensor], rank: int, seed: int = 0,
               model_state: dict | None = None, frozen: dict[str, torch.Tensor] | None = None) -> TrainState:
    """One worker's state for the collective backend, from its own f32
    ``params`` and ``model_state`` (per-worker shapes, no worker axis):
    held as a stack of one, with per-worker CHOCO state and the dropout
    generator of the simulated backend's worker ``rank``; ``frozen`` as
    :func:`init_stacked_state`'s."""
    model_state = {} if model_state is None else model_state
    frozen = _check_frozen(params, frozen)
    one = lambda t: t.unsqueeze(0)  # noqa: E731
    params = {n: one(p) for n, p in params.items()}
    model_state = T.tree_map(one, model_state)
    for path, p in [((n,), p) for n, p in params.items()] + T.flatten_with_paths(model_state):
        if p.dtype != torch.float32:
            raise ValueError(f"{'.'.join(map(str, path))}: expected f32, got {p.dtype}")
    device = next(iter(params.values())).device
    return TrainState(
        step=0,
        params=params,
        model_state=model_state,
        opt_state=cfg.optimizer.init(params, 1),
        gossip=cfg.engine().init_state(_gossiped(*_row(params, model_state))),
        generators=[worker_generator(device, seed, rank)],
        frozen=frozen,
        fault_generators=[fault_generator(seed, rank)] if cfg.gossip.faults is not None else [],
        outer=slowmo_init(params) if cfg.outer is not None else None,
    )


def _row(params: dict, model_state: dict) -> tuple[dict, dict]:
    """The worker's tensors of a stack of one, as views without the axis."""
    return {n: p[0] for n, p in params.items()}, T.tree_map(lambda t: t[0], model_state)


def rank_batch(batch: dict, rank: int) -> dict:
    """Rank ``rank``'s share of a stacked ``(W, H, B, ...)`` round batch:
    row ``rank`` with a worker axis of one, what the collective step
    takes."""
    return {k: v[rank: rank + 1] for k, v in batch.items()}


def worker_grads(cfg: LocalSGDConfig, loss_fn: LossFn, state: TrainState, worker: int, batch: dict):
    """One worker's loss and gradients on one batch, nothing updated:
    ``(loss, {name: grad}, new_model_state)`` with a gradient for each
    leaf the optimizer trains (the others, and the frozen base, get none).
    With ``cfg.micro_batch`` smaller than the batch, the gradient is summed
    over micro-batches of that many rows, each weighted by
    ``loss_fn.count(micro) / max(loss_fn.count(batch), 1)``, and so is the
    loss: the whole batch's, in another rounding order."""
    views = {n: p[worker] for n, p in state.params.items()}
    trained = [n for n in views if cfg.optimizer.trains(n)]
    leaves = {n: v.detach().requires_grad_(n in trained) for n, v in views.items()}
    ms_leaves, ms_spec = T.flatten(state.model_state)
    model_state = T.unflatten(ms_spec, [x[worker] for x in ms_leaves])
    tensors = {**state.frozen, **leaves}
    wrt = [leaves[n] for n in trained]
    gen = state.generators[worker]
    rows = next(iter(batch.values())).shape[0]
    if not 0 < cfg.micro_batch < rows:
        loss, new_state = loss_fn(tensors, model_state, batch, gen)
        return loss.detach(), dict(zip(trained, torch.autograd.grad(loss, wrt))), new_state
    count = getattr(loss_fn, "count", None)
    if count is None or ms_leaves:
        raise ValueError("micro-batches need a loss with a count (its divisor) and no model state")
    total = torch.clamp(count(batch), min=1.0)
    grads = loss = None
    for lo in range(0, rows, cfg.micro_batch):
        part = {k: v[lo: lo + cfg.micro_batch] for k, v in batch.items()}
        part_loss, new_state = loss_fn(tensors, model_state, part, gen)
        weighted = part_loss * (count(part) / total)
        part_grads = torch.autograd.grad(weighted, wrt)
        grads = list(part_grads) if grads is None else [g + q for g, q in zip(grads, part_grads)]
        loss = weighted.detach() if loss is None else loss + weighted.detach()
        del part_loss, weighted, part_grads
    return loss, dict(zip(trained, grads)), new_state


def worker_step(cfg: LocalSGDConfig, loss_fn: LossFn, state: TrainState, worker: int,
                batch: dict) -> torch.Tensor:
    """One local optimizer step of one worker on one batch, in place
    (:func:`worker_grads`): the loss's new model state is written over the
    worker's, then the optimizer steps. Returns the loss (a 0-dim tensor
    on the device)."""
    loss, grads, new_state = worker_grads(cfg, loss_fn, state, worker, batch)
    ms_leaves, ms_spec = T.flatten(state.model_state)
    new_leaves, new_spec = T.flatten(new_state)
    if new_spec != ms_spec:
        raise ValueError("loss_fn returned a model_state of another structure than it was given")
    with torch.no_grad():
        for dst, src in zip(ms_leaves, new_leaves):
            dst[worker].copy_(src)
    views = {n: p[worker] for n, p in state.params.items()}
    cfg.optimizer.update_(views, grads, state.opt_state, worker)
    return loss


def _worker_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every stacked tensor a worker's local steps write: parameters,
    model state and the optimizer state's (``AdamState.count``, a
    schedule's count and the clip's norm included)."""
    return list(state.params.values()) + T.leaves(state.model_state) + [t for _, t in T.named_tensors(state.opt_state)]


def local_steps(cfg: LocalSGDConfig, loss_fn: LossFn, state: TrainState, worker: int,
                batches: list[dict]) -> tuple[torch.Tensor, float]:
    """Worker ``worker``'s local steps, one a batch, in place: ``(mean
    loss, ok)``. With ``cfg.gossip.faults`` detecting non-finite values,
    ``ok`` is whether the loss, the parameters and the model state came
    out finite (reduced on the device, read once), and a worker that
    failed is restored to the rows it held before the steps; otherwise
    ``ok`` is 1."""
    faults = cfg.gossip.faults
    check = faults is not None and faults.detect_nonfinite
    snapshot = [t[worker].clone() for t in _worker_tensors(state)] if check else None
    loss = torch.stack([worker_step(cfg, loss_fn, state, worker, b) for b in batches]).mean()
    if not check:
        return loss, 1.0
    rows = ([p[worker] for p in state.params.values()], [x[worker] for x in T.leaves(state.model_state)])
    ok = float(tree_all_finite(loss, rows))
    if not ok:
        with torch.no_grad():
            for t, saved in zip(_worker_tensors(state), snapshot):
                t[worker].copy_(saved)
    return loss, ok


def make_simulated_train_step(cfg: LocalSGDConfig, loss_fn: LossFn):
    """``step(state, batch, alive=None) -> (state, metrics)`` for stacked
    workers on one device: per worker (one at a time) H local steps
    (:func:`local_steps`), then one gossip round through the mixing
    matrix (a time-varying topology's phase ``step % period``, for exact
    mixing and CHOCO alike), then the consensus error. With
    ``cfg.gossip.faults``, ``alive`` (``(world,)`` 0/1) replaces the
    round's injected draws, the finite check still applied; without
    faults it is refused. ``metrics``: ``loss`` (mean over the kept
    workers of each worker's mean over its H steps), ``consensus_error``,
    the host wall time of the inner loop and of the gossip round in ms
    (both end in a device synchronisation), for image batches
    ``imgs_per_s`` (W x H x B over the round's wall time), and with faults
    ``alive_frac`` and ``alive_mask``. With ``cfg.gossip.overlap`` the
    round is overlap gossip's (module docstring): ``gossip_ms`` is then
    the correction's apply and computation, before the local steps."""
    engine = cfg.engine()
    topo = cfg.gossip.topology
    faults = cfg.gossip.faults
    # time-varying topologies: stack the phase matrices once, index by round
    w_all = simulated.phase_matrices(topo) if topo.is_time_varying else simulated.mixing_matrix(topo)

    def overlap_round(state: TrainState, batch: dict, world: int, h: int, device, sync):
        t0 = time.perf_counter()
        w = (w_all[state.step % topo.period] if topo.is_time_varying else w_all).to(device)
        z = engine.apply_correction(_gossiped(state.params, state.model_state), state.gossip)
        # the applied correction and the old params released before the next correction's peak
        state.params, state.model_state = z["params"], z["model_state"]
        state.gossip = state.gossip._replace(correction=None)
        state.gossip = engine.correction_simulated(z, w, state.gossip)
        del z
        err = engine.consensus_error_simulated(state.params)
        sync()
        t1 = time.perf_counter()
        losses = torch.stack([
            local_steps(cfg, loss_fn, state, i, [{k: v[i, j] for k, v in batch.items()} for j in range(h)])[0]
            for i in range(world)
        ])
        sync()
        t2 = time.perf_counter()
        state.step += 1
        metrics = {"loss": losses.mean(), "consensus_error": err, "inner_ms": 1e3 * (t2 - t1),
                   "gossip_ms": 1e3 * (t1 - t0)}
        if "image" in batch:
            metrics["imgs_per_s"] = world * h * batch["image"].shape[2] / (t2 - t0)
        return state, metrics

    def step(state: TrainState, batch: dict, alive=None):
        if alive is not None and faults is None:
            raise ValueError("an alive mask needs cfg.gossip.faults (FaultConfig(drop_prob=0.0) for given masks only)")
        first = next(iter(batch.values()))
        world, h = first.shape[0], first.shape[1]
        if h != cfg.h:
            raise ValueError(
                f"batch inner-step axis is {h} but LocalSGDConfig.h={cfg.h}; each round "
                "batch must carry exactly h microbatches per worker"
            )
        device = next(iter(state.params.values())).device
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        if cfg.gossip.overlap:
            return overlap_round(state, {k: v.to(device) for k, v in batch.items()}, world, h, device, sync)
        t0 = time.perf_counter()
        batch = {k: v.to(device) for k, v in batch.items()}
        per_worker, oks = [], []
        for w in range(world):
            loss, ok = local_steps(cfg, loss_fn, state, w, [{k: v[w, i] for k, v in batch.items()} for i in range(h)])
            per_worker.append(loss)
            oks.append(ok)
        losses = torch.stack(per_worker)
        mask = None
        if faults is not None:
            keep = torch.tensor(oks, dtype=torch.float32, device=device)
            if alive is None:
                alive = [draw_alive(g, faults.drop_prob) for g in state.fault_generators]
            mask = torch.as_tensor(alive, dtype=torch.float32).to(device) * keep
        sync()
        t1 = time.perf_counter()
        w = w_all[state.step % topo.period] if topo.is_time_varying else w_all
        w = w.to(device)
        mixed, state.gossip = engine.round_simulated(
            _gossiped(state.params, state.model_state), state.gossip, w, step=state.step, alive=mask
        )
        state.params, state.model_state = mixed["params"], mixed["model_state"]
        if cfg.outer is not None:
            slowmo_update_(cfg.outer, state.params, state.outer)
        err = engine.consensus_error_simulated(state.params)
        sync()
        t2 = time.perf_counter()
        state.step += 1
        metrics = {
            # the reference's mean over the kept workers, sum(keep * losses) /
            # max(sum(keep), 1): a rolled-back worker's NaN loss times 0 is NaN
            "loss": losses.mean() if mask is None else (keep * losses).sum() / torch.clamp(keep.sum(), min=1.0),
            "consensus_error": err,
            "inner_ms": 1e3 * (t1 - t0),
            "gossip_ms": 1e3 * (t2 - t1),
        }
        if mask is not None:
            metrics["alive_frac"] = mask.mean()
            metrics["alive_mask"] = mask
        if "image" in batch:
            metrics["imgs_per_s"] = world * h * batch["image"].shape[2] / (t2 - t0)
        return state, metrics

    return step


def make_collective_train_step(cfg: LocalSGDConfig, loss_fn: LossFn, mesh):
    """``step(state, batch) -> (state, metrics)`` for THIS rank's worker
    (:func:`init_state`; ``batch`` leaves ``(1, H, B, ...)``, its row of
    the stacked batch): H local steps (:func:`local_steps`), one
    :meth:`~consensusml_tpu_torch.consensus.ConsensusEngine.round_collective`
    over ``mesh`` on the gossiped tree (a time-varying topology's phase
    ``step % period``; with faults, this rank's flag ``inject * ok``, its
    draw from its own fault generator), the consensus error, and the loss
    as an all-reduce mean over the kept workers: every rank gets the same
    ``loss`` and ``consensus_error``.

    Ranks that share a card (``mesh.shares_device``) take their local
    steps in rank order, each releasing its cached blocks before the
    next begins, so one worker's activations are on the card at a time
    (the card runs one rank's kernels at a time anyway).

    ``metrics`` has the simulated step's keys (``gossip_ms`` is the gossip
    round alone here) and ``metrics_ms``, the consensus error's and the
    loss's all-reduces (the error's first one moves the whole parameter
    tree), ``wire_bytes``, the bytes this rank's transport sent in the
    gossip round (the flags' 4 bytes a shift included), and that round's
    ``staging_ms``, ``wire_ms`` and ``bytes_staged``; with faults
    ``alive_frac`` and ``alive_mask`` (every rank's flag, in rank order).

    With ``cfg.gossip.overlap`` the round is overlap gossip's (module
    docstring): the correction's exchange is posted before the local
    steps and finished after them; ``gossip_ms`` is then
    ``gossip_issue_ms`` (the apply, the correction's encode, staging and
    requests) plus ``gossip_wait_ms`` (the wait left after the local
    steps, the copy back and the receive's fold), and ``metrics_ms`` the
    consensus error's (on ``z``, before the local steps) and the loss's
    all-reduces; the transport figures are the correction's."""
    engine = cfg.engine()
    faults = cfg.gossip.faults
    if engine.topology != mesh.topology:
        raise ValueError("the mesh is bound to another topology than the config's")

    def own_steps(state, batch):
        return local_steps(cfg, loss_fn, state, 0, [{k: v[0, i] for k, v in batch.items()} for i in range(cfg.h)])

    def all_steps(state, batch, sync):
        """This rank's local steps; on a shared card in rank order."""
        if not mesh.shares_device:
            return own_steps(state, batch)
        for turn in range(mesh.world_size):
            if turn == mesh.rank:
                loss, ok = own_steps(state, batch)
                sync()
                torch.cuda.empty_cache()
            mesh.barrier()
        return loss, ok

    def overlap_round(state: TrainState, batch: dict, sync):
        stats = mesh.transport.stats
        t0 = time.perf_counter()
        before = stats.snapshot()
        z = engine.apply_correction(_gossiped(*_row(state.params, state.model_state)), state.gossip)
        state.params = {n: t.unsqueeze(0) for n, t in z["params"].items()}
        state.model_state = T.tree_map(lambda t: t.unsqueeze(0), z["model_state"])
        state.gossip = state.gossip._replace(correction=None)
        inflight = engine.correction_collective_start(z, state.gossip, mesh, step=state.step)
        sync()
        issued = stats.since(before)
        t1 = time.perf_counter()
        err = engine.consensus_error_collective(z["params"], mesh)
        del z
        sync()
        t2 = time.perf_counter()
        loss, _ok = all_steps(state, batch, sync)
        sync()
        t3 = time.perf_counter()
        before = stats.snapshot()
        state.gossip = inflight.wait()
        sync()
        waited = stats.since(before)
        t4 = time.perf_counter()
        if mesh.shares_device:
            torch.cuda.empty_cache()
        mean_loss = collectives.all_reduce_mean([loss.reshape(1)], mesh)[0][0]
        sync()
        t5 = time.perf_counter()
        state.step += 1
        wire = {k: issued[k] + waited[k] for k in issued}
        metrics = {
            "loss": mean_loss, "consensus_error": err, "inner_ms": 1e3 * (t3 - t2),
            "gossip_ms": 1e3 * ((t1 - t0) + (t4 - t3)), "gossip_issue_ms": 1e3 * (t1 - t0),
            "gossip_wait_ms": 1e3 * (t4 - t3), "metrics_ms": 1e3 * ((t2 - t1) + (t5 - t4)),
            "wire_bytes": wire["bytes_sent"], "bytes_staged": wire["bytes_staged"],
            "staging_ms": wire["staging_ms"], "wire_ms": wire["wire_ms"],
        }
        if "image" in batch:
            metrics["imgs_per_s"] = cfg.h * batch["image"].shape[2] / (t5 - t0)
        return state, metrics

    def step(state: TrainState, batch: dict):
        first = next(iter(batch.values()))
        if first.shape[0] != 1 or first.shape[1] != cfg.h:
            raise ValueError(
                f"a rank's batch must be (1, h={cfg.h}, B, ...) (its row of the stacked batch), "
                f"got leading shape {tuple(first.shape[:2])}"
            )
        device = mesh.device
        sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
        if cfg.gossip.overlap:
            return overlap_round(state, {k: v.to(device) for k, v in batch.items()}, sync)
        t0 = time.perf_counter()
        batch = {k: v.to(device) for k, v in batch.items()}
        loss, ok = all_steps(state, batch, sync)
        alive = None if faults is None else draw_alive(state.fault_generators[0], faults.drop_prob) * ok
        sync()
        t1 = time.perf_counter()
        before = mesh.transport.stats.snapshot()
        mixed, state.gossip = engine.round_collective(
            _gossiped(*_row(state.params, state.model_state)), state.gossip, mesh, step=state.step, alive=alive
        )
        wire = mesh.transport.stats.since(before)
        state.params = {n: t.unsqueeze(0) for n, t in mixed["params"].items()}
        state.model_state = T.tree_map(lambda t: t.unsqueeze(0), mixed["model_state"])
        if cfg.outer is not None:
            slowmo_update_(cfg.outer, state.params, state.outer)
        sync()
        t2 = time.perf_counter()
        if mesh.shares_device:
            torch.cuda.empty_cache()  # the round's temporaries, before another rank's turn
        err = engine.consensus_error_collective(mixed["params"], mesh)
        if faults is None:
            mean_loss = collectives.all_reduce_mean([loss.reshape(1)], mesh)[0][0]
        else:
            # one sum: ok * loss, ok, and every rank's flag in its own slot
            row = torch.zeros(2 + mesh.world_size, dtype=torch.float32, device=device)
            row[0], row[1], row[2 + mesh.rank] = ok * loss, ok, alive
            total = mesh.transport.all_reduce_sum([row])[0]
            mean_loss = total[0] / torch.clamp(total[1], min=1.0)
            mask = total[2:]
        sync()
        t3 = time.perf_counter()
        state.step += 1
        metrics = {
            "loss": mean_loss,
            "consensus_error": err,
            "inner_ms": 1e3 * (t1 - t0),
            "gossip_ms": 1e3 * (t2 - t1),
            "metrics_ms": 1e3 * (t3 - t2),
            "wire_bytes": wire["bytes_sent"],
            "bytes_staged": wire["bytes_staged"],
            "staging_ms": wire["staging_ms"],
            "wire_ms": wire["wire_ms"],
        }
        if faults is not None:
            metrics["alive_frac"] = mask.mean()
            metrics["alive_mask"] = mask
        if "image" in batch:
            metrics["imgs_per_s"] = cfg.h * batch["image"].shape[2] / (t3 - t0)
        return state, metrics

    return step
