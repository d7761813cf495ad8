"""Deterministic churn schedules: the reproducible chaos fixture (port of
``consensusml_tpu/swarm/churn.py``: host code, drawing from the same
``numpy.random.default_rng(seed)`` in the same order, so a seed gives the
reference's schedule event for event).

A :class:`ChurnSchedule` is a fixed list of membership events pinned to
round indices — the seeded, replayable input the churn tests and the
card's churn phase run against. Two ways to build one:

- **generate** — ``ChurnSchedule.generate(seed=.., rounds=.., joins=..,
  drops=.., stragglers=.., initial_world=..)`` draws event rounds and
  targets from ``numpy.random.default_rng(seed)``: same seed, same
  schedule, forever.
- **parse** — an explicit spec string, one event per ``;``-separated
  term (also what ``python -m consensusml_tpu_torch.train
  --churn-schedule`` accepts):

      join@R[:N]        N workers join at round R (default 1)
      drop@R:U[,U..]    slots U.. drop (preempted) at round R
      rejoin@R:U[,U..]  previously dropped slots U.. rejoin at round R
      straggle@R:UxD    slot U misses gossip for D rounds from round R

  or the generator form ``seed=S,rounds=R,joins=J,drops=D,stragglers=K``
  which calls :meth:`generate`.

Semantics of an event at round R (enforced by the harness): drops and
straggles take effect IN round R (the mask the in-flight round mixes
with — a mid-round drop is exactly ``masked_mixing_matrix``/push-sum's
alive mask); joins bootstrap DURING round R and participate from round
R+1 (the membership view transition lands at the boundary, barrier-free
for the in-flight round). Rejoins lift the frozen mask at round R.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ChurnEvent", "ChurnSchedule"]

KINDS = ("join", "drop", "rejoin", "straggle")


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    round: int
    kind: str  # join | drop | rejoin | straggle
    workers: tuple[int, ...] = ()  # slot uids (drop/rejoin/straggle)
    n: int = 1  # joiner count (join)
    duration: int = 1  # straggle rounds (straggle)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"bad churn event kind {self.kind!r}")
        if self.round < 0:
            raise ValueError(f"event round must be >= 0, got {self.round}")
        if self.kind == "join" and self.n < 1:
            raise ValueError(f"join needs n >= 1, got {self.n}")
        if self.kind != "join" and not self.workers:
            raise ValueError(f"{self.kind} needs worker slots")
        if self.kind == "straggle" and self.duration < 1:
            raise ValueError(
                f"straggle needs duration >= 1, got {self.duration}"
            )

    def spec(self) -> str:
        if self.kind == "join":
            return f"join@{self.round}:{self.n}"
        us = ",".join(str(u) for u in self.workers)
        if self.kind == "straggle":
            return f"straggle@{self.round}:{us}x{self.duration}"
        return f"{self.kind}@{self.round}:{us}"


@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """An ordered, validated churn event list."""

    events: tuple[ChurnEvent, ...]

    def __post_init__(self):
        object.__setattr__(
            self,
            "events",
            tuple(sorted(self.events, key=lambda e: (e.round, e.kind))),
        )

    # ---- queries ---------------------------------------------------------
    def events_at(self, rnd: int) -> list[ChurnEvent]:
        return [e for e in self.events if e.round == rnd]

    @property
    def total_joins(self) -> int:
        return sum(e.n for e in self.events if e.kind == "join")

    def counts(self) -> dict[str, int]:
        out = {k: 0 for k in KINDS}
        for e in self.events:
            out[e.kind] += e.n if e.kind == "join" else len(e.workers)
        return out

    def spec(self) -> str:
        """Canonical serialization; ``parse(spec())`` round-trips."""
        return ";".join(e.spec() for e in self.events)

    # ---- construction ----------------------------------------------------
    @classmethod
    def parse(
        cls, spec: str, initial_world: int | None = None
    ) -> "ChurnSchedule":
        """``initial_world`` is the generator default when the spec does
        not name one (the train CLI passes the run's actual world)."""
        spec = spec.strip()
        if "@" not in spec and "=" in spec:
            kv = {}
            for term in spec.split(","):
                k, _, v = term.partition("=")
                kv[k.strip()] = int(v)
            unknown = set(kv) - {
                "seed", "rounds", "joins", "drops", "stragglers",
                "initial_world",
            }
            if unknown:
                raise ValueError(
                    f"unknown churn-schedule keys {sorted(unknown)}"
                )
            if "rounds" not in kv:
                raise ValueError("generator spec needs rounds=<int>")
            return cls.generate(
                seed=kv.get("seed", 0),
                rounds=kv["rounds"],
                joins=kv.get("joins", 3),
                drops=kv.get("drops", 2),
                stragglers=kv.get("stragglers", 1),
                initial_world=kv.get("initial_world", initial_world or 4),
            )
        events = []
        for term in spec.split(";"):
            term = term.strip()
            if not term:
                continue
            head, _, arg = term.partition(":")
            kind, at, rnd = head.partition("@")
            if not at:
                raise ValueError(
                    f"bad churn event {term!r} (expected kind@round[:arg])"
                )
            kind = kind.strip()
            rnd = int(rnd)
            if kind == "join":
                events.append(
                    ChurnEvent(rnd, "join", n=int(arg) if arg else 1)
                )
            elif kind in ("drop", "rejoin"):
                if not arg:
                    raise ValueError(f"{kind}@{rnd} needs worker slots")
                events.append(
                    ChurnEvent(
                        rnd, kind,
                        workers=tuple(int(u) for u in arg.split(",")),
                    )
                )
            elif kind == "straggle":
                us, x, dur = arg.partition("x")
                events.append(
                    ChurnEvent(
                        rnd, "straggle",
                        workers=tuple(int(u) for u in us.split(",")),
                        duration=int(dur) if x else 1,
                    )
                )
            else:
                raise ValueError(
                    f"unknown churn event kind {kind!r} "
                    f"(expected one of {KINDS})"
                )
        if not events:
            raise ValueError(f"empty churn schedule {spec!r}")
        return cls(events=tuple(events))

    @classmethod
    def generate(
        cls,
        seed: int,
        rounds: int,
        joins: int = 3,
        drops: int = 2,
        stragglers: int = 1,
        initial_world: int = 4,
    ) -> "ChurnSchedule":
        """Seeded schedule with the requested event mix.

        Deterministic rules: event rounds are drawn without replacement
        from ``[1, rounds-2]`` (round 0 warms compile, the last round
        stays churn-free so the post-churn loss is measured on a full
        round); drops target distinct INITIAL members (never a fresh
        joiner, never slot 0 — someone must anchor the bootstrap
        neighborhood); every drop rejoins 2 rounds later when the window
        allows; stragglers pick initial members not already dropped, for
        2 rounds each.
        """
        if rounds < 4:
            raise ValueError(f"need rounds >= 4 for a churn window, got {rounds}")
        if initial_world < 2:
            raise ValueError(
                f"initial_world must be >= 2, got {initial_world}"
            )
        n_events = joins + drops + stragglers
        window = range(1, rounds - 1)
        if n_events > len(window):
            raise ValueError(
                f"{n_events} events do not fit in rounds 1..{rounds - 2}"
            )
        droppable = max(initial_world - 1, 1)
        if drops > droppable:
            raise ValueError(
                f"{drops} drops exceed the {droppable} droppable initial "
                f"members (slot 0 anchors the swarm)"
            )
        rng = np.random.default_rng(seed)
        when = sorted(
            int(r) for r in rng.choice(list(window), size=n_events, replace=False)
        )
        kinds = ["join"] * joins + ["drop"] * drops + ["straggle"] * stragglers
        rng.shuffle(kinds)
        drop_pool = list(rng.permutation(np.arange(1, initial_world)))
        events: list[ChurnEvent] = []
        dropped_at: dict[int, int] = {}
        for rnd, kind in zip(when, kinds):
            if kind == "join":
                events.append(ChurnEvent(rnd, "join", n=1))
            elif kind == "drop":
                u = int(drop_pool.pop())
                events.append(ChurnEvent(rnd, "drop", workers=(u,)))
                dropped_at[u] = rnd
            else:
                # straggle an initial member that is not mid-drop at rnd
                cands = [
                    u for u in range(initial_world)
                    if not (u in dropped_at and dropped_at[u] <= rnd)
                ]
                u = int(rng.choice(cands)) if cands else 0
                events.append(
                    ChurnEvent(rnd, "straggle", workers=(u,), duration=2)
                )
        # every drop rejoins 2 rounds later (clamped inside the window)
        for u, rnd in sorted(dropped_at.items()):
            back = min(rnd + 2, rounds - 2)
            if back > rnd:
                events.append(ChurnEvent(back, "rejoin", workers=(u,)))
        return cls(events=tuple(events))
