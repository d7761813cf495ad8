"""Gossip bootstrap: a joiner reconstructs state from neighbour gossip (port
of ``consensusml_tpu/swarm/bootstrap.py``).

The checkpoint-free join. Instead of reading an artifact, a joiner
enters the NEW topology (the view re-derived at world + n) holding zero
parameters and zero push-sum mass, while every existing member holds its
replica at unit mass. Push-sum partial sums then flow over the new edges
(:func:`~consensusml_tpu_torch.consensus.pushsum.pushsum_round_simulated`,
the exact operator a recovery round uses):

    x(0) = [x_1 .. x_W, 0 .. 0]      w(0) = [1 .. 1, 0 .. 0]

A doubly-stochastic mixing matrix is column-stochastic, so BOTH sums are
conserved every round: ``sum x(k) = sum_old x_i`` and ``sum w(k) = W``.
Each worker's de-biased ratio ``z = x / w`` therefore converges to

    sum(x) / sum(w)  =  (1/W) * sum_old x_i  =  utils.tree.consensus_mean(x_old)

— the same definition of "the consensus model" evaluation, elastic
resume and serving export share — with geometric rate: after K rounds
the standard push-sum bound gives

    ||z_j(K) - mean|| <= (C / w_min(K)) * rho^K,   rho = 1 - spectral_gap

so :func:`bootstrap_rounds_for` picks K from the topology's own
contraction and the requested epsilon. The function also REPORTS the
realized error (measured against ``consensus_mean`` in f64 on the host)
so the guarantee is checked, not assumed, on every join.

Survivors are untouched: the bootstrap rounds run on a scratch copy and
only the JOINER rows are taken from the result — a join never perturbs a
live replica (the same contract as ``utils.elastic.resize_state``'s grow).
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

from consensusml_tpu_torch.comm import simulated
from consensusml_tpu_torch.consensus.pushsum import PushSumState, pushsum_round_simulated
from consensusml_tpu_torch.topology import Topology
from consensusml_tpu_torch.utils import tree as T

__all__ = ["bootstrap_rounds_for", "gossip_bootstrap", "bootstrap_joiners"]


def bootstrap_rounds_for(topology: Topology, tol: float = 1e-3, lo: int = 4, hi: int = 64) -> int:
    """Rounds of neighbour gossip for a joiner to land within ``tol``
    (relative) of the swarm mean: ``K = ceil(log tol / log rho)`` from the
    topology's per-round contraction ``rho``, clamped to ``[lo, hi]``.
    Time-varying topologies contract per PERIOD, so K scales by it."""
    gap = topology.spectral_gap()
    period = topology.period if topology.is_time_varying else 1
    rho = 1.0 - max(min(gap, 1.0), 0.0)
    if rho <= 0.0:
        return max(lo, period)  # dense: one round is exact, keep the floor
    k = int(np.ceil(np.log(tol) / np.log(rho))) * period
    return int(min(max(k, lo), hi))


def gossip_bootstrap(tree: Any, topology: Topology, n_new: int, rounds: int | None = None, tol: float = 1e-3,
                     alive: Any | None = None) -> tuple[Any, dict]:
    """Bootstrap ``n_new`` joiner replicas from neighbour gossip.

    ``tree``: the survivors' stacked ``(W, ...)`` tensors (parameters and
    — gossip carries it too — model state). ``topology``: the NEW view's
    topology, already re-derived at ``W + n_new``. ``rounds``: run
    exactly this many gossip rounds; None (default) sizes the first
    burst from the spectral gap and then EXTENDS until every joiner
    measures within ``tol`` of the mean (capped at 64 rounds). Returns
    ``(joiner_rows, info)``: stacked ``(n_new, ...)`` tensors in the
    survivors' dtypes plus an info dict with the rounds run, the epsilon
    TARGET, and the measured relative error of each joiner against
    ``consensus_mean`` — the enforced half of the within-epsilon
    guarantee.

    ``alive``: optional ``(W,)`` 0/1 mask over the survivors. Rows at 0
    (DEAD members whose replicas froze rounds ago) get ZERO initial
    push-sum mass, so they contribute nothing to the partial sums and
    the joiner converges to — and is measured against — the mean of the
    LIVE swarm.
    """
    leaves = T.leaves(tree)
    n_old = int(leaves[0].shape[0])
    n = n_old + n_new
    device = leaves[0].device
    if topology.world_size != n:
        raise ValueError(
            f"topology is sized {topology.world_size}, expected {n_old} survivors + {n_new} joiners = {n}"
        )
    if rounds is not None and rounds < 1:
        raise ValueError(f"bootstrap rounds must be >= 1, got {rounds}")
    max_rounds = 64 if rounds is None else rounds
    # explicit rounds= runs EXACTLY that many; None sizes the first burst
    # from the spectral gap and extends adaptively below
    target = bootstrap_rounds_for(topology, tol=tol, hi=max_rounds) if rounds is None else rounds
    phases = topology.phases if topology.is_time_varying else (topology,)
    ws = [simulated.mixing_matrix(p, device=device) for p in phases]
    # scratch copy: survivors' live replicas never move
    x = T.tree_map(
        lambda v: torch.cat([v.to(torch.float32),
                             torch.zeros((n_new, *v.shape[1:]), dtype=torch.float32, device=device)]),
        tree)
    if alive is None:
        mass0 = torch.ones((n_old,), dtype=torch.float32, device=device)
    else:
        mass0 = torch.as_tensor(alive, dtype=torch.float32).to(device).reshape((n_old,))
        if float(mass0.sum()) < 1.0:
            raise ValueError("gossip bootstrap needs at least one alive survivor")
    state = PushSumState(w=torch.cat([mass0, torch.zeros((n_new,), dtype=torch.float32, device=device)]))
    # a DEAD row holds zero mass, so its frozen replica never enters the
    # partial sums; the reference mean is the ALIVE members' mean — the
    # same quantity the sums converge to
    if alive is None:
        mean = T.tree_map(lambda v: v.to(torch.float32), T.consensus_mean(tree))
    else:
        mean = T.tree_map(lambda v: T.masked_worker_mean(v, mass0), tree)

    def measure(x) -> np.ndarray:
        """Per-joiner relative deviation from the shared consensus-mean
        definition (one host fetch; join-time, not per-round)."""
        sq_err = np.zeros(n_new)
        sq_ref = 0.0
        for x_leaf, m_leaf in zip(T.leaves(x), T.leaves(mean)):
            j_host = x_leaf[n_old:].detach().cpu().numpy().astype(np.float64).reshape(n_new, -1)
            m_host = m_leaf.detach().cpu().numpy().astype(np.float64).reshape(-1)
            sq_err += ((j_host - m_host[None, :]) ** 2).sum(axis=1)
            sq_ref += float((m_host ** 2).sum())
        return np.sqrt(sq_err) / max(np.sqrt(sq_ref), 1e-12)

    # the spectral-gap estimate sizes the first burst; the push-sum bound's
    # constant (C / w_min) can exceed 1, so the guarantee is ENFORCED by
    # measuring and extending — never assumed from the estimate alone
    period = len(ws)
    done = 0
    rel = None
    while done < max_rounds:
        burst = target if done == 0 else max(period, min(8, max_rounds - done))
        burst = min(burst, max_rounds - done)
        for k in range(done, done + burst):
            x, state = pushsum_round_simulated(x, state, ws[k % period])
        done += burst
        rel = measure(x)
        if rounds is not None or float(rel.max()) <= tol:
            break

    # the joiner rows, cast to the survivors' dtypes (the state they join)
    joiners = T.tree_map(lambda j, v: j[n_old:].to(v.dtype), x, tree)
    converged = float(rel.max()) <= tol
    if rounds is None and not converged:
        # the cap truncated the adaptive loop below tol: the joiner still
        # enters (its replica is the best available estimate and later
        # gossip keeps contracting), but loudly
        warnings.warn(
            f"gossip bootstrap hit the {max_rounds}-round cap at eps={float(rel.max()):.3g} > tol={tol:.3g} on "
            f"{topology.name}(world={n}); the joiner enters OUTSIDE the requested epsilon (poorly-mixing "
            "topology — raise tol, pass rounds=, or pick a better-connected graph)",
            stacklevel=2,
        )
    info = {
        "rounds": int(done),
        "tol": float(tol),
        "eps_measured": float(rel.max()),
        "eps_per_joiner": [float(r) for r in rel],
        "converged": converged,
        "topology": topology.name,
        "world": n,
    }
    return joiners, info


def bootstrap_joiners(cfg, state, n_new: int, topology: Topology, seed: int = 0, rounds: int | None = None,
                      tol: float = 1e-3, alive: Any | None = None):
    """Grow a stacked :class:`~consensusml_tpu_torch.train.local_sgd.TrainState`
    by ``n_new`` gossip-bootstrapped joiners — the swarm counterpart of the
    checkpoint-boundary ``resize_state`` grow, with NO checkpoint read.

    Bootstraps parameters and model state jointly (they gossip jointly),
    then hands the concatenation, the optimizer's init, the generators
    (keyed on ``seed``) and the gossip reset to
    ``resize_state(joiner_params=...)``. Returns ``(new_state, info)``.
    """
    from consensusml_tpu_torch.obs import get_registry
    from consensusml_tpu_torch.obs.metrics import DEFAULT_ROUND_COUNT_BUCKETS
    from consensusml_tpu_torch.utils.elastic import resize_state

    old_world = len(state.generators)
    rows, info = gossip_bootstrap({"params": state.params, "model_state": state.model_state}, topology, n_new,
                                  rounds=rounds, tol=tol, alive=alive)
    new_state = resize_state(cfg, state, old_world + n_new, seed=seed, joiner_params=rows["params"],
                             joiner_model_state=rows["model_state"])
    reg = get_registry()
    reg.counter(
        "consensusml_swarm_bootstrapped_joiners_total",
        "joiners whose replica came from neighbor gossip (no checkpoint read)",
    ).inc(n_new)
    reg.gauge(
        "consensusml_swarm_bootstrap_epsilon",
        "latest join's measured relative deviation from the consensus mean",
    ).set(info["eps_measured"])
    reg.histogram(
        "consensusml_swarm_bootstrap_rounds",
        "neighbor-gossip rounds each join spent reconstructing state",
        buckets=DEFAULT_ROUND_COUNT_BUCKETS,
    ).observe(info["rounds"])
    return new_state, info
