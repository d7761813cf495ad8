"""Live membership: epoch-stamped member views with barrier-free handoff
(port of ``consensusml_tpu/swarm/membership.py``: host code, as the
reference's, with its lock and ``@guarded_by`` contract).

The swarm's source of truth for "who is in the run right now". A
:class:`MemberView` is an immutable snapshot — epoch counter, per-member
status, and the :class:`~consensusml_tpu_torch.topology.Topology` re-derived
for the view's world size — and the :class:`MembershipController` owns
the sequence of views:

- **propose** stages membership events (join / drop / rejoin /
  straggle) against the CURRENT view; nothing changes yet.
- **advance** applies the staged events at a round boundary: a new view
  (epoch + 1) becomes current, its topology re-derived via
  :func:`consensusml_tpu_torch.topology.rederive` whenever the world size
  changed.
- **pin / release** implement the barrier-free transition protocol: a
  gossip round pins the view it launched against, and that view stays
  valid — retrievable, its topology/mask intact — until released, even
  across any number of ``advance`` calls. In-flight rounds therefore
  complete against the old view while the next round picks up the new
  one; no barrier, no drain. ``advance`` never blocks on pins.

The pin/advance protocol (plus the ``_fed_epoch`` gauge-feed claim
below) guarantees that rounds complete against their pinned epoch across
any number of advances, and that no gauge feed lands at an older epoch
than the newest claimed.

Statuses: ``active`` members gossip and train; ``dead`` members
(dropped/preempted) are frozen — their replica is untouched until a
rejoin; ``straggling`` members keep training locally but miss gossip
until their straggle window expires (auto-recovered by ``advance``).
Dead and straggling members keep their SLOT — the stacked state row and
the topology vertex — so consensus runs over the full graph with an
alive mask, which is exactly the regime push-sum-weighted recovery
(``GossipConfig.push_sum="auto"``) keeps mean-exact.

Thread contract: the controller is read from the training thread and
(in multi-controller deployments) written from a membership-event
thread, so the view chain is lock-guarded, each lock's fields declared
with ``@guarded_by``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterable

import numpy as np

from consensusml_tpu_torch.obs._annotations import guarded_by
from consensusml_tpu_torch.topology import Topology, rederive

__all__ = ["Member", "MemberView", "MembershipController", "ACTIVE", "DEAD", "STRAGGLING"]

ACTIVE = "active"
DEAD = "dead"
STRAGGLING = "straggling"


@dataclasses.dataclass(frozen=True)
class Member:
    """One swarm member. ``uid`` doubles as the member's SLOT: its row in
    the stacked state and its vertex in the topology (stable for the
    member's lifetime, including across drop/rejoin)."""

    uid: int
    status: str = ACTIVE
    joined_epoch: int = 0
    # straggle bookkeeping: rounds of gossip left to miss (auto-recovers)
    straggle_left: int = 0

    def __post_init__(self):
        if self.status not in (ACTIVE, DEAD, STRAGGLING):
            raise ValueError(f"bad member status {self.status!r}")


@dataclasses.dataclass(frozen=True)
class MemberView:
    """Immutable epoch-stamped membership snapshot."""

    epoch: int
    members: tuple[Member, ...]  # slot order: members[i].uid == i
    topology: Topology  # derived at world_size = len(members)

    @property
    def world_size(self) -> int:
        return len(self.members)

    @property
    def active(self) -> tuple[int, ...]:
        return tuple(m.uid for m in self.members if m.status == ACTIVE)

    @property
    def n_active(self) -> int:
        return sum(1 for m in self.members if m.status == ACTIVE)

    def alive_mask(self) -> np.ndarray:
        """``(world,)`` f32: 1 for members that gossip this round (active),
        0 for dead AND straggling ones (a straggler's payload is late, so
        the round proceeds without it — it re-syncs through later gossip)."""
        return np.asarray(
            [1.0 if m.status == ACTIVE else 0.0 for m in self.members],
            np.float32,
        )

    def frozen_mask(self) -> np.ndarray:
        """``(world,)`` f32: 1 for members whose replica is FROZEN (dead:
        the worker is gone, its row must not move); stragglers still train."""
        return np.asarray(
            [1.0 if m.status == DEAD else 0.0 for m in self.members],
            np.float32,
        )


@guarded_by("_lock", "_current", "_staged", "_pins", "_retired")
@guarded_by("_feed_lock", "_fed_epoch")
class MembershipController:
    """Owner of the live member view; see the module docstring for the
    propose/advance/pin protocol."""

    def __init__(self, topology: Topology, registry=None):
        self._lock = threading.Lock()
        members = tuple(
            Member(uid=i) for i in range(topology.world_size)
        )
        self._current = MemberView(epoch=0, members=members, topology=topology)
        self._staged: list[tuple[str, tuple]] = []
        # epoch -> pin refcount; views stay reachable while pinned
        self._pins: dict[int, int] = {}
        self._retired: dict[int, MemberView] = {}
        self._registry = registry
        # serializes the GAUGE side of metric feeds: the claim and the
        # sets must be one critical section or a preempted older feed
        # could land its gauge values after a newer one's. Dedicated
        # lock (not _lock) so the view lock never spans foreign metric
        # locks; Gauge/Registry locks are leaves, so no cycle is
        # possible through this hold.
        self._feed_lock = threading.Lock()
        self._fed_epoch = -1  # newest epoch whose gauges were fed
        self._feed_metrics(self._current, events=())

    # ---- reads -----------------------------------------------------------
    def view(self) -> MemberView:
        """The current view (a snapshot; never mutated)."""
        with self._lock:
            return self._current

    def pin(self) -> MemberView:
        """Pin the current view for an in-flight round. The returned view
        stays valid across ``advance`` until :meth:`release` — the
        barrier-free half of the transition protocol."""
        with self._lock:
            v = self._current
            self._pins[v.epoch] = self._pins.get(v.epoch, 0) + 1
            self._retired.setdefault(v.epoch, v)
            return v

    def release(self, view: MemberView) -> None:
        """Release a pinned view; fully-released non-current epochs drop."""
        with self._lock:
            n = self._pins.get(view.epoch, 0) - 1
            if n < 0:
                raise ValueError(f"epoch {view.epoch} was not pinned")
            if n == 0:
                del self._pins[view.epoch]
                if view.epoch != self._current.epoch:
                    self._retired.pop(view.epoch, None)
            else:
                self._pins[view.epoch] = n

    def pinned_epochs(self) -> tuple[int, ...]:
        """Epochs with live pins (transition-protocol introspection)."""
        with self._lock:
            return tuple(sorted(self._pins))

    # ---- staging ---------------------------------------------------------
    def propose_join(self, n: int = 1) -> None:
        """Stage ``n`` joiners; they take slots ``world..world+n-1`` at the
        next ``advance`` (the caller bootstraps their replicas then)."""
        if n < 1:
            raise ValueError(f"join count must be positive, got {n}")
        with self._lock:
            self._staged.append(("join", (int(n),)))

    def propose_drop(self, uids: Iterable[int]) -> None:
        with self._lock:
            self._staged.append(("drop", tuple(int(u) for u in uids)))

    def propose_rejoin(self, uids: Iterable[int]) -> None:
        with self._lock:
            self._staged.append(("rejoin", tuple(int(u) for u in uids)))

    def propose_straggle(self, uids: Iterable[int], rounds: int = 1) -> None:
        if rounds < 1:
            raise ValueError(f"straggle rounds must be positive, got {rounds}")
        with self._lock:
            self._staged.append(
                ("straggle", (tuple(int(u) for u in uids), int(rounds)))
            )

    # ---- transition ------------------------------------------------------
    def advance(self) -> MemberView:
        """Apply the staged events: install the next epoch's view as
        current and return it. Straggle windows tick down here (a member
        whose window hits zero recovers to active). Never blocks on pins;
        a no-event advance with no straggler ticks returns the current
        view unchanged (no epoch burn)."""
        with self._lock:
            staged, self._staged = self._staged, []
            cur = self._current
            members = list(cur.members)
            # tick straggle windows first: recovery is visible in the same
            # view as this boundary's events
            ticked = False
            for i, m in enumerate(members):
                if m.status == STRAGGLING:
                    ticked = True
                    left = m.straggle_left - 1
                    members[i] = dataclasses.replace(
                        m,
                        status=ACTIVE if left <= 0 else STRAGGLING,
                        straggle_left=max(left, 0),
                    )
            if not staged and not ticked:
                return cur
            new_epoch = cur.epoch + 1
            events = []
            for kind, args in staged:
                if kind == "join":
                    (n,) = args
                    base = len(members)
                    for k in range(n):
                        members.append(
                            Member(uid=base + k, joined_epoch=new_epoch)
                        )
                    events.append(("join", tuple(range(base, base + n))))
                elif kind == "drop":
                    for u in args:
                        self._check_slot(members, u)
                        members[u] = dataclasses.replace(
                            members[u], status=DEAD, straggle_left=0
                        )
                    events.append(("drop", args))
                elif kind == "rejoin":
                    for u in args:
                        self._check_slot(members, u)
                        if members[u].status != DEAD:
                            raise ValueError(
                                f"rejoin of member {u} which is "
                                f"{members[u].status}, not dead"
                            )
                        members[u] = dataclasses.replace(
                            members[u], status=ACTIVE
                        )
                    events.append(("rejoin", args))
                elif kind == "straggle":
                    uids, rounds = args
                    for u in uids:
                        self._check_slot(members, u)
                        if members[u].status == DEAD:
                            raise ValueError(
                                f"straggle of dead member {u}"
                            )
                        members[u] = dataclasses.replace(
                            members[u], status=STRAGGLING, straggle_left=rounds
                        )
                    events.append(("straggle", uids))
                else:  # pragma: no cover - staging validates kinds
                    raise AssertionError(kind)
            if sum(1 for m in members if m.status == ACTIVE) < 1:
                raise ValueError(
                    "membership change would leave no active member"
                )
            topo = cur.topology
            if len(members) != cur.world_size:
                topo = rederive(topo, len(members))
            new = MemberView(
                epoch=new_epoch, members=tuple(members), topology=topo
            )
            self._current = new
            # drop fully-released retired views; keep pinned ones alive
            self._retired = {
                e: v for e, v in self._retired.items() if e in self._pins
            }
        # metrics feed OUTSIDE the view lock: gauge/counter updates take
        # the registry's and each metric's own lock, and holding the
        # controller lock across foreign locks is exactly the cross-class
        # nesting the lockorder pass exists to keep out of the graph.
        # _feed_metrics's monotonic-epoch claim keeps two racing
        # advances from feeding the gauges in the wrong order; the view
        # itself was installed atomically above.
        self._feed_metrics(new, events)
        return new

    @staticmethod
    def _check_slot(members: list, u: int) -> None:
        if not 0 <= u < len(members):
            raise ValueError(
                f"member {u} out of range (world is {len(members)})"
            )

    # ---- telemetry -------------------------------------------------------
    def _feed_metrics(self, view: MemberView, events) -> None:
        """The ``consensusml_swarm_*`` families.

        Runs OUTSIDE the view lock (see :meth:`advance`): the gauges
        carry a monotonic-epoch claim so two advances racing into their
        feeds cannot leave the gauges at the older epoch; event counters
        always count (they are per-event totals, not point-in-time).
        """
        if self._registry is None:
            return
        reg = self._registry
        with self._feed_lock:
            # claim + sets are ONE critical section: a feed that merely
            # claimed first but set last would leave the gauges at the
            # older epoch until the next advance
            if view.epoch >= self._fed_epoch:
                self._fed_epoch = view.epoch
                reg.gauge(
                    "consensusml_swarm_epoch",
                    "membership epoch of the live member view",
                ).set(view.epoch)
                reg.gauge(
                    "consensusml_swarm_members",
                    "members currently ACTIVE in the swarm",
                ).set(view.n_active)
                reg.gauge(
                    "consensusml_swarm_world_size",
                    "total member slots (active + dead + straggling)",
                ).set(view.world_size)
        for kind, uids in events:
            reg.counter(
                "consensusml_swarm_events_total",
                "membership events applied, by kind",
                labels={"kind": kind},
            ).inc(max(len(uids), 1))
