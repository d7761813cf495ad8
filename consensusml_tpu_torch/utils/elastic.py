"""Elastic world membership: resume a run at a different worker count (port
of ``consensusml_tpu/utils/elastic.py``).

``python -m consensusml_tpu_torch.train --resume DIR/step_N --workers W'``
restores a checkpoint written at any world size and resizes the stacked
state to the new world (:func:`resize_state`), on both backends.

Semantics, the reference's:

- **shrink** (W -> W' < W): replicas ``0..W'-1`` keep their exact state
  (parameters, model state, optimizer state, generators). Departed
  workers' replicas are dropped — the same information loss a real leave
  event causes; every mixing matrix row is a convex combination, so the
  survivors' consensus is unaffected.
- **grow** (W -> W' > W): joiners start from the CONSENSUS MEAN of the
  existing replicas (:func:`~consensusml_tpu_torch.utils.tree.consensus_mean`,
  what a real joiner would fetch from the network) with a FRESH optimizer
  state from ``cfg.optimizer`` and fresh generators, their round counter
  row 0's; then they drift apart through local SGD.
- **gossip state is reset for everyone**: CHOCO's ``xhat``/``s`` tracking
  and push-sum's mass are invariants over a FIXED membership; compressed
  gossip re-warms its error feedback over a few rounds, the honest cost of
  a membership change.
- **SlowMo restarts** (``x = params, u = 0``).

Joiners' generators (the port's seeded contract, in place of the
reference's ``fold_in(key(seed + 1), i)``): joiner ``i`` (its slot, ``W
<= i < W'``) draws dropout from ``worker_generator(device, seed + 1, i)``
and injected faults from ``fault_generator(seed + 1, i)``, so that a grow
is reproducible from ``seed`` on either backend.

The three ``consensusml_elastic_*`` families (resizes, joined workers,
world size) are fed into the process's registry.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from consensusml_tpu_torch.utils import tree as T

__all__ = ["resize_state", "joiner_generators", "record_resize"]


def _map_tensors(fn, obj: Any, *others: Any) -> Any:
    """``obj`` rebuilt with every tensor ``t`` replaced by ``fn(t, *o)``,
    ``o`` the tensors at the same place of ``others`` (same structure):
    dataclasses, NamedTuples, dicts, lists and tuples are rebuilt, other
    values kept (``None``, numbers)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *others)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_tensors(fn, getattr(obj, f.name), *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return obj._replace(**{f: _map_tensors(fn, getattr(obj, f), *(getattr(o, f) for o in others))
                               for f in obj._fields})
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v, *(o[k] for o in others)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, v, *(o[i] for o in others)) for i, v in enumerate(obj))
    return obj


def joiner_generators(device, seed: int, slots, faults: bool) -> tuple[list, list]:
    """The dropout and (with ``faults``) fault generators of the joiners in
    ``slots``: keyed on ``(seed + 1, slot)`` (module docstring)."""
    from consensusml_tpu_torch.consensus.faults import fault_generator
    from consensusml_tpu_torch.train.local_sgd import worker_generator

    gens = [worker_generator(device, seed + 1, i) for i in slots]
    fgens = [fault_generator(seed + 1, i) for i in slots] if faults else []
    return gens, fgens


def record_resize(old_world: int, new_world: int) -> None:
    """The ``consensusml_elastic_*`` families of one resize."""
    from consensusml_tpu_torch.obs import get_registry

    reg = get_registry()
    reg.counter(
        "consensusml_elastic_resizes_total",
        "elastic world-membership changes applied at resume",
    ).inc()
    reg.counter(
        "consensusml_elastic_joined_workers_total",
        "workers bootstrapped from the consensus mean by elastic grows",
    ).inc(max(0, new_world - old_world))
    reg.gauge(
        "consensusml_elastic_world_size",
        "stacked world size after the latest elastic resize "
        "(cluster-view membership)",
    ).set(new_world)


def _copy_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def _stack_rows(mean: torch.Tensor, n_new: int, like: torch.Tensor) -> torch.Tensor:
    return mean.unsqueeze(0).expand((n_new, *mean.shape)).to(like.dtype)


def resize_state(cfg, state, new_world: int, seed: int = 0, joiner_params: dict | None = None,
                 joiner_model_state: Any | None = None):
    """Return ``state`` (stacked, :class:`~consensusml_tpu_torch.train.
    local_sgd.TrainState`) resized to ``new_world`` replicas; the input is
    left as it was. No-op when the size already matches. ``seed`` keys the
    joiners' generators (module docstring).

    ``joiner_params`` / ``joiner_model_state`` (grow only): stacked
    ``(n_new, ...)`` rows the joiners start from INSTEAD of the
    consensus-mean broadcast — the swarm's gossip-bootstrap path
    (:mod:`consensusml_tpu_torch.swarm.bootstrap`), where a joiner has
    reconstructed its replica from neighbour gossip and no checkpoint was
    read. The optimizer state is fresh either way (initialised on the
    joiner rows)."""
    from consensusml_tpu_torch.train.local_sgd import TrainState, _gossiped
    from consensusml_tpu_torch.train.outer import slowmo_init

    old_world = len(state.generators)
    if new_world == old_world:
        return state
    if new_world < 1:
        raise ValueError(f"new_world must be positive, got {new_world}")
    record_resize(old_world, new_world)
    faults = cfg.gossip.faults is not None
    if new_world < old_world:
        if joiner_params is not None:
            raise ValueError("joiner_params only applies when growing")
        take = lambda x: x[:new_world].clone()  # noqa: E731
        params = {n: take(p) for n, p in state.params.items()}
        model_state = T.tree_map(take, state.model_state)
        opt_state = _map_tensors(take, state.opt_state)
        gens = [_copy_generator(g) for g in state.generators[:new_world]]
        fgens = [_copy_generator(g) for g in state.fault_generators[:new_world]] if faults else []
    else:
        n_new = new_world - old_world
        if joiner_params is not None:
            # gossip-bootstrapped joiners: rows come from the caller
            new_p = {n: joiner_params[n].to(p.dtype) for n, p in state.params.items()}
            new_ms = (T.tree_map(lambda r, x: r.to(x.dtype), joiner_model_state, state.model_state)
                      if joiner_model_state is not None
                      else T.tree_map(lambda m, x: _stack_rows(m, n_new, x), T.consensus_mean(state.model_state),
                                      state.model_state))
        else:
            mean_p = T.consensus_mean(state.params)
            new_p = {n: _stack_rows(mean_p[n], n_new, p) for n, p in state.params.items()}
            new_ms = T.tree_map(lambda m, x: _stack_rows(m, n_new, x), T.consensus_mean(state.model_state),
                                state.model_state)
        params = {n: torch.cat([p, new_p[n]]) for n, p in state.params.items()}
        model_state = T.tree_map(lambda x, r: torch.cat([x, r]), state.model_state, new_ms)
        # joiners: fresh optimizer state on their rows
        new_opt = cfg.optimizer.init(new_p, n_new)
        opt_state = _map_tensors(lambda a, b: torch.cat([a, b.to(device=a.device, dtype=a.dtype)]),
                                state.opt_state, new_opt)
        device = next(iter(state.params.values())).device
        jg, jf = joiner_generators(device, seed, range(old_world, new_world), faults)
        gens = [_copy_generator(g) for g in state.generators] + jg
        fgens = [_copy_generator(g) for g in state.fault_generators] + jf if faults else []
    return TrainState(
        step=state.step,
        params=params,
        model_state=model_state,
        opt_state=opt_state,
        # membership changed: tracking and mass invariants of the old world
        # no longer hold — reset (module docstring)
        gossip=cfg.engine().init_state(_gossiped(params, model_state), world_size=new_world),
        generators=gens,
        frozen=state.frozen,
        fault_generators=fgens,
        outer=slowmo_init(params) if cfg.outer is not None else None,
    )
