"""The churn harness: replay a seeded membership schedule while training
(port of ``consensusml_tpu/swarm/harness.py``).

Workers join and leave while training never stops, run end to end on the
simulated backend, deterministically:

- the :class:`~consensusml_tpu_torch.swarm.membership.MembershipController`
  owns the epoch-stamped view; every round PINS the view it launches
  against and the boundary's events ADVANCE the next epoch underneath it
  (barrier-free: the in-flight round completes on the old view);
- **drops** land mid-round as alive-mask zeros — exactly the masked
  mixing / push-sum alive semantics, with push-sum recovery engaged
  whenever the view's topology is asymmetric (``GossipConfig.push_sum=
  "auto"``) — and the dropped member's replica is FROZEN (its inner loop
  rolled back) until it rejoins;
- **stragglers** keep training locally but miss gossip for their window;
- **joins** gossip-bootstrap the new replica from neighbours during the
  round (:mod:`consensusml_tpu_torch.swarm.bootstrap` — NO checkpoint
  read) and participate from the next round, with the topology
  re-derived at the new world size.

Membership changes the stacked world size, so each distinct world gets a
step of its own (built once, counted as a rebuild, the reference's
recompile).

Batches come from any ``(rounds, seed) -> iterator`` source built at the
schedule's CAPACITY (initial world + total joins); each round slices the
leading axis down to the current world, so worker slot ``i`` consumes the
same stream with or without churn.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from consensusml_tpu_torch.comm import simulated
from consensusml_tpu_torch.consensus.faults import FaultConfig, record_fault_metrics
from consensusml_tpu_torch.swarm.bootstrap import bootstrap_joiners
from consensusml_tpu_torch.swarm.churn import ChurnSchedule
from consensusml_tpu_torch.swarm.membership import DEAD, MembershipController
from consensusml_tpu_torch.topology import rederive
from consensusml_tpu_torch.utils import tree as T

__all__ = [
    "ChurnReport",
    "alive_consensus_state",
    "churn_config",
    "run_churn",
    "validate_schedule",
]


def alive_consensus_state(state, view):
    """A copy of ``state`` whose DEAD members' frozen rows are replaced by
    the ALIVE members' consensus mean — what evaluation (and any mean-model
    consumer) should see after a run that ended with members still down.
    The raw state is the honest CHECKPOINT content (a frozen replica is
    exactly what a rejoin resumes from); this view is for aggregation,
    where a stale replica would silently bias the mean model."""
    frozen = np.asarray(view.frozen_mask(), np.float32)
    if not frozen.any():
        return state

    def fix(x):
        keep = torch.as_tensor(1.0 - frozen, device=x.device)
        k = keep.reshape((-1,) + (1,) * (x.dim() - 1))
        mean = T.masked_worker_mean(x, keep)
        return torch.where(k > 0, x, mean.to(x.dtype)[None])

    return dataclasses.replace(state, params={n: fix(p) for n, p in state.params.items()},
                               model_state=T.tree_map(fix, state.model_state))


@dataclasses.dataclass
class ChurnReport:
    """What one churn replay produced (plain data; JSON-able via
    ``summary()`` except the final state)."""

    losses: list[float]
    consensus_errors: list[float]  # over ALIVE members (masked)
    alive_fracs: list[float]
    round_s: list[float]  # wall time per round (bootstrap time excluded)
    events: list[dict]  # timeline rows: round/kind/workers/epoch/detail
    world_trajectory: list[tuple[int, int]]  # (round, active members)
    bootstraps: list[dict]  # per-join gossip_bootstrap info
    recompiles: int
    final_state: Any
    final_view: Any
    wall_s: float

    def summary(self) -> dict:
        return {
            "rounds": len(self.losses),
            "final_loss": self.losses[-1] if self.losses else None,
            "final_consensus_error": self.consensus_errors[-1] if self.consensus_errors else None,
            "events": self.events,
            "world_trajectory": self.world_trajectory,
            "bootstraps": self.bootstraps,
            "recompiles": self.recompiles,
            "wall_s": round(self.wall_s, 3),
        }


def churn_config(cfg):
    """A LocalSGDConfig ready for scheduled churn: the alive-mask gossip
    plumbing on (``FaultConfig(drop_prob=0)`` unless faults are already
    configured) and push-sum recovery as the default under asymmetric
    membership (``push_sum="auto"`` unless explicitly set)."""
    gossip = cfg.gossip
    if gossip.compressor is not None:
        raise NotImplementedError(
            "churn on a compressed-gossip config is not supported: CHOCO "
            "tracking assumes every peer applies every innovation, which "
            "a membership change violates (use an exact-mixing config)"
        )
    if gossip.overlap:
        raise NotImplementedError(
            "churn + overlap gossip is not supported: a dropped round "
            "would apply a correction computed against a W the peer "
            "never participated in"
        )
    changes = {}
    if gossip.faults is None:
        changes["faults"] = FaultConfig(drop_prob=0.0)
    if gossip.push_sum is False:
        changes["push_sum"] = "auto"
    if changes:
        gossip = dataclasses.replace(gossip, **changes)
    return dataclasses.replace(cfg, gossip=gossip)


def validate_schedule(schedule: ChurnSchedule, topology, rounds: int) -> int:
    """Dry-replay ``schedule`` against a scratch controller so an invalid
    event sequence (rejoin of a never-dropped member, straggle of a dead
    one, an event past ``rounds`` or outside capacity) fails BEFORE any
    training round runs, with the offending round in the message. Returns
    the capacity the replay reached. ``run_churn`` calls this itself; the
    CLI calls it up front to turn bad specs into a clean exit."""
    initial = topology.world_size
    capacity = initial + schedule.total_joins
    for e in schedule.events:
        if e.round >= rounds:
            raise ValueError(f"churn event {e.spec()} lands beyond the {rounds}-round run")
        if e.kind != "join" and max(e.workers) >= capacity:
            raise ValueError(f"churn event {e.spec()} targets slot {max(e.workers)} outside capacity {capacity}")
    ctl = MembershipController(topology)
    for rnd in range(rounds):
        # stage in run_churn's EXACT order — non-join events during the
        # round, joins only at the boundary (after bootstrap) — so the
        # dry replay accepts/rejects precisely what the live loop would
        joins = 0
        rejoined: set[int] = set()
        for e in schedule.events_at(rnd):
            if e.kind == "join":
                joins += e.n
            elif e.kind == "drop":
                ctl.propose_drop(e.workers)
            elif e.kind == "rejoin":
                ctl.propose_rejoin(e.workers)
                rejoined.update(e.workers)
            elif e.kind == "straggle":
                # a same-round rejoin re-activates the member before the
                # controller applies the straggle, so it doesn't count as
                # dead here (matches advance's staged-order semantics)
                view = ctl.view()
                for u in e.workers:
                    if u not in rejoined and u < view.world_size and view.members[u].status == DEAD:
                        raise ValueError(f"churn schedule invalid at round {rnd}: straggle of dead member {u}")
                if e.duration > 1:
                    # the event round itself is masked directly in the
                    # live loop; the controller window covers the rest
                    ctl.propose_straggle(e.workers, rounds=e.duration - 1)
        if joins:
            ctl.propose_join(joins)
        try:
            ctl.advance()
        except ValueError as err:
            raise ValueError(f"churn schedule invalid at round {rnd}: {err}") from err
    return capacity


def run_churn(cfg, loss_fn, init, schedule: ChurnSchedule, rounds: int, batches: Callable[..., Any],
              seed: int = 0, registry=None, bootstrap_tol: float = 1e-3,
              on_round: Callable[[int, dict], None] | None = None,
              on_event: Callable[[dict], None] | None = None) -> ChurnReport:
    """Train ``rounds`` rounds under ``schedule`` on the simulated backend.

    ``init``: ``(params, model_state)``, the stacked initial variables at
    the INITIAL world (``cfg``'s topology size; the reference draws them
    from ``init_params`` here), from which the state is built with
    ``churn_config(cfg)`` and ``seed``. ``batches(rounds, seed)`` must yield round batches
    stacked at CAPACITY = initial world + ``schedule.total_joins`` (extra
    rows are sliced off while the world is smaller). ``on_round(rnd,
    row)`` / ``on_event(row)`` are observation hooks (the train CLI's
    logging and cluster-timeline feed).
    """
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state

    t0 = time.time()
    cfg = churn_config(cfg)
    initial = cfg.gossip.topology.world_size
    # fail on a bad event sequence BEFORE round 0, not mid-training
    validate_schedule(schedule, cfg.gossip.topology, rounds)
    params, model_state = init
    state = init_stacked_state(cfg, params, initial, seed=seed, model_state=model_state)

    controller = MembershipController(cfg.gossip.topology, registry=registry)
    cfg_by_world = {initial: cfg}
    step_cache: dict[int, Any] = {}

    def cfg_at(world: int):
        if world not in cfg_by_world:
            cfg_by_world[world] = dataclasses.replace(
                cfg, gossip=dataclasses.replace(cfg.gossip, topology=rederive(cfg.gossip.topology, world)))
        return cfg_by_world[world]

    def step_at(world: int):
        from consensusml_tpu_torch.train.local_sgd import make_simulated_train_step

        if world not in step_cache:
            step_cache[world] = make_simulated_train_step(cfg_at(world), loss_fn)
            # a membership-driven world change costs one step rebuild
            report.recompiles += 1
        return step_cache[world]

    report = ChurnReport(
        losses=[], consensus_errors=[], alive_fracs=[], round_s=[],
        events=[], world_trajectory=[], bootstraps=[], recompiles=0,
        final_state=None, final_view=None, wall_s=0.0,
    )

    def record_event(rnd, kind, workers, epoch, detail=None):
        row = {"round": rnd, "kind": kind, "workers": [int(u) for u in workers], "epoch": epoch}
        if detail:
            row["detail"] = detail
        report.events.append(row)
        if on_event is not None:
            on_event(row)
        if registry is not None:
            registry.gauge(
                "consensusml_swarm_last_event_round",
                "round index of the latest membership event",
            ).set(rnd)

    prev_alive = None
    for rnd, batch in zip(range(rounds), batches(rounds, seed)):
        t_round = time.time()
        # the in-flight round runs against the view pinned HERE; the
        # boundary's events install the next epoch underneath it
        view = controller.pin()
        try:
            events = schedule.events_at(rnd)
            # mid-round drops/straggles mask THIS round's gossip; the
            # epoch transition itself lands at the boundary below
            alive = view.alive_mask()
            frozen = view.frozen_mask()
            joins = 0
            for e in events:
                if e.kind == "drop":
                    # slots are pre-validated by the dry replay above
                    for u in e.workers:
                        if u < view.world_size:
                            alive[u] = 0.0
                            frozen[u] = 1.0
                    controller.propose_drop(e.workers)
                    record_event(rnd, "drop", e.workers, view.epoch)
                elif e.kind == "straggle":
                    # this round is missed via the mask below; the
                    # controller window covers the REMAINING duration-1
                    # rounds, so the member misses exactly `duration`
                    for u in e.workers:
                        if u < view.world_size:
                            alive[u] = 0.0
                    if e.duration > 1:
                        controller.propose_straggle(e.workers, rounds=e.duration - 1)
                    elif registry is not None:
                        # a 1-round straggle is applied wholly via the
                        # mask above and never reaches the controller —
                        # count it here so events_total agrees with the
                        # timeline
                        registry.counter(
                            "consensusml_swarm_events_total",
                            "membership events applied, by kind",
                            labels={"kind": "straggle"},
                        ).inc(len(e.workers))
                    record_event(rnd, "straggle", e.workers, view.epoch, {"duration": e.duration})
                elif e.kind == "rejoin":
                    # the member is back for this round: unfreeze + gossip
                    for u in e.workers:
                        if u < view.world_size:
                            alive[u] = 1.0
                            frozen[u] = 0.0
                    controller.propose_rejoin(e.workers)
                    record_event(rnd, "rejoin", e.workers, view.epoch)
                elif e.kind == "join":
                    joins += e.n

            world = view.world_size
            step = step_at(world)
            sliced = {k: v[:world] for k, v in batch.items()}
            state, metrics = step(state, sliced, alive.tolist(), frozen.tolist())
            loss = float(metrics["loss"])
            mask = metrics["alive_mask"].detach().cpu().numpy()
            err_alive = float(simulated.consensus_error_masked(state.params, metrics["alive_mask"]))
            alive_frac = float(metrics["alive_frac"])
            report.losses.append(loss)
            report.consensus_errors.append(err_alive)
            report.alive_fracs.append(alive_frac)
            report.world_trajectory.append((rnd, int(mask.sum())))
            record_fault_metrics(alive_frac, alive=mask.tolist(), prev_alive=prev_alive)
            prev_alive = mask.tolist()
            if registry is not None and alive.sum() < world:
                # the recovery rounds counter: gossip proceeded with a
                # partial membership (push-sum-weighted when asymmetric)
                registry.counter(
                    "consensusml_swarm_recovery_rounds_total",
                    "gossip rounds completed under a partial alive mask",
                ).inc()

            # boundary: joins bootstrap NOW (during round rnd, against the
            # post-round replicas) and participate from rnd + 1
            if joins:
                report.round_s.append(time.time() - t_round)
                t_boot = time.time()
                new_world = world + joins
                new_topo = cfg_at(new_world).gossip.topology
                state, info = bootstrap_joiners(
                    cfg_at(new_world), state, joins, new_topo, seed=seed, tol=bootstrap_tol,
                    # DEAD members' frozen replicas carry zero bootstrap
                    # mass: the joiner reconstructs the LIVE swarm's mean
                    # (stragglers are late, not stale — they stay in)
                    alive=1.0 - frozen,
                )
                info["wall_s"] = round(time.time() - t_boot, 4)
                report.bootstraps.append({"round": rnd, **info})
                controller.propose_join(joins)
                record_event(rnd, "join", list(range(world, new_world)), view.epoch,
                             {"bootstrap_rounds": info["rounds"], "eps_measured": info["eps_measured"]})
            new_view = controller.advance()
            if on_round is not None:
                on_round(rnd, {
                    "loss": loss,
                    "consensus_error": err_alive,
                    "alive_frac": alive_frac,
                    "epoch": new_view.epoch,
                    "world": new_view.world_size,
                    "active": new_view.n_active,
                })
        finally:
            controller.release(view)
        if len(report.round_s) <= rnd:
            report.round_s.append(time.time() - t_round)

    report.final_state = state
    report.final_view = controller.view()
    report.wall_s = time.time() - t0
    return report
