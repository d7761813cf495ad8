"""Live swarm membership: churn without stopping training (port of
``consensusml_tpu/swarm``), built from four parts:

- :mod:`~consensusml_tpu_torch.swarm.membership` — the
  :class:`MembershipController`: epoch-stamped member views, topology
  re-derivation on change, and a barrier-free pin/advance transition
  protocol (in-flight gossip rounds complete against the old view while
  the next round uses the new one).
- :mod:`~consensusml_tpu_torch.swarm.churn` — deterministic churn
  schedules (:class:`ChurnSchedule`): seeded generation or an explicit
  spec string (``python -m consensusml_tpu_torch.train --churn-schedule``).
- :mod:`~consensusml_tpu_torch.swarm.bootstrap` — gossip bootstrap: a
  joiner reconstructs its replica from neighbour gossip via push-sum
  partial sums over the new edges (measured within epsilon of
  ``utils.tree.consensus_mean`` of the swarm — no checkpoint read).
- :mod:`~consensusml_tpu_torch.swarm.harness` — :func:`run_churn`, the
  simulated-backend replay loop tying them together, with push-sum
  weighted recovery as the default whenever membership goes asymmetric
  (``GossipConfig.push_sum="auto"``).
"""

from consensusml_tpu_torch.swarm.bootstrap import (  # noqa: F401
    bootstrap_joiners,
    bootstrap_rounds_for,
    gossip_bootstrap,
)
from consensusml_tpu_torch.swarm.churn import ChurnEvent, ChurnSchedule  # noqa: F401
from consensusml_tpu_torch.swarm.harness import (  # noqa: F401
    ChurnReport,
    alive_consensus_state,
    churn_config,
    run_churn,
    validate_schedule,
)
from consensusml_tpu_torch.swarm.membership import (  # noqa: F401
    Member,
    MembershipController,
    MemberView,
)
