"""Live membership in the port (``consensusml_tpu_torch.swarm``) held to the
reference's ``consensusml_tpu.swarm``.

- Churn schedules from ``parse`` and ``generate`` equal the reference's
  event for event (both draw from ``numpy.random.default_rng(seed)``), and
  ``validate_schedule`` refuses what the reference refuses, with the same
  message (the offending round in it).
- The membership controller's views over one scripted sequence of
  proposals, advances, pins and releases: epochs, statuses, alive and
  frozen masks, rederived topologies (name and mixing matrices, exact),
  pinned epochs; the lock contract (``__guarded_by__``) is the reference's.
- ``gossip_bootstrap`` on seeded stacked trees: the same rounds, the
  measured epsilon to 1e-3 relative or 1e-6 absolute (an epsilon near
  1e-6 is the f32 rows' own rounding against the mean's norm), the joiner
  rows to 1e-6; survivors untouched.
- ``run_churn`` on ``mnist_mlp`` smoke from the reference's initial state
  (converted by ``state_from_reference``) under the same schedule: the
  loss and the alive members' consensus error every round at the
  ``mnist_mlp`` curve tolerance of ``tests/test_torch_mnist.py`` (loss 1e-6
  absolute, error 1e-4 relative), the same events, world trajectory and bootstrap rounds.
- A frozen worker's replica is bit-unchanged by a round; the CLI's
  ``--churn-schedule`` refusals exit 2 and its run prints the membership
  lines and the ``swarm final:`` summary, its cluster snapshot renders the
  membership timeline.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu import swarm as jswarm
from consensusml_tpu import topology as jtopology
from consensusml_tpu_torch import configs, swarm, topology
from consensusml_tpu_torch.consensus.faults import FaultConfig
from consensusml_tpu_torch.train.__main__ import main
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
from consensusml_tpu_torch.utils.checkpoint import state_from_reference

LOSS_ATOL, ERR_RTOL = 1e-6, 1e-4
EPS_RTOL, EPS_ATOL, ROW_ATOL = 1e-3, 1e-6, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(schedule):
    return [dataclasses.astuple(e) for e in schedule.events]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

GENERATED = [dict(seed=s, rounds=r, joins=j, drops=d, stragglers=k, initial_world=w)
             for s, r, j, d, k, w in [(0, 12, 3, 2, 1, 4), (1, 12, 3, 2, 1, 4), (7, 20, 4, 3, 2, 6),
                                      (42, 8, 1, 1, 1, 3), (3, 30, 6, 5, 3, 8)]]
SPECS = ["join@1:2;drop@2:3;straggle@3:5x2;rejoin@4:3", "join@3", "drop@1:1,2;rejoin@3:1,2;straggle@2:0",
         "seed=5,rounds=10", "seed=2,rounds=16,joins=2,drops=1,stragglers=2,initial_world=5"]


@pytest.mark.parametrize("kw", GENERATED, ids=[str(i) for i in range(len(GENERATED))])
def test_generated_schedules_equal_the_reference(kw):
    got, want = swarm.ChurnSchedule.generate(**kw), jswarm.ChurnSchedule.generate(**kw)
    assert _events(got) == _events(want)
    assert got.spec() == want.spec() and got.counts() == want.counts()
    assert _events(swarm.ChurnSchedule.parse(got.spec())) == _events(got)


@pytest.mark.parametrize("spec", SPECS)
def test_parsed_schedules_equal_the_reference(spec):
    got, want = swarm.ChurnSchedule.parse(spec, initial_world=4), jswarm.ChurnSchedule.parse(spec, initial_world=4)
    assert _events(got) == _events(want) and got.spec() == want.spec()


BAD = [("rejoin@2:1", 6), ("drop@1:2;straggle@3:2x2", 6), ("join@7", 6), ("drop@1:9", 6),
       ("drop@1:0,1,2,3", 6), ("join@1;drop@2:5", 6), ("straggle@1:0x0", 6), ("bogus@1", 6),
       ("seed=1", 6), ("seed=1,rounds=3", 6), ("", 6), ("drop@1", 6)]


@pytest.mark.parametrize("spec,rounds", BAD, ids=[b[0] or "empty" for b in BAD])
def test_validate_schedule_refuses_as_the_reference(spec, rounds):
    def outcome(mod, topo):
        try:
            mod.validate_schedule(mod.ChurnSchedule.parse(spec, initial_world=4), topo, rounds)
        except ValueError as e:
            return str(e)
        return None

    want = outcome(jswarm, jtopology.RingTopology(4))
    got = outcome(swarm, topology.RingTopology(4))
    assert want is not None and got == want


# ---------------------------------------------------------------------------
# the membership controller
# ---------------------------------------------------------------------------


def _matrices(topo):
    mats = topo.phase_matrices() if topo.is_time_varying else [topo.mixing_matrix()]
    return [np.asarray(m).tolist() for m in mats]


def _script(mod, topo_cls, args):
    """One scripted run of a controller: each view's epoch, statuses,
    masks, topology and the pinned epochs."""
    ctl = mod.MembershipController(topo_cls(*args))
    seen = []

    def record(v):
        seen.append((v.epoch, [m.status for m in v.members], v.alive_mask().tolist(), v.frozen_mask().tolist(),
                     v.topology.name, v.topology.world_size, _matrices(v.topology),
                     ctl.pinned_epochs()))

    v0 = ctl.pin()
    ctl.propose_join(2)
    record(ctl.advance())
    record(v0)
    ctl.propose_drop([1])
    ctl.propose_straggle([3], rounds=2)
    record(ctl.advance())
    v2 = ctl.pin()
    record(ctl.advance())
    ctl.release(v0)
    record(ctl.advance())
    ctl.propose_rejoin([1])
    ctl.propose_join(1)
    record(ctl.advance())
    ctl.release(v2)
    record(ctl.advance())  # no event: the same view
    try:
        ctl.propose_rejoin([0])
        ctl.advance()
    except ValueError as e:
        seen.append(str(e))
    return seen


@pytest.mark.parametrize("name,args", [("RingTopology", (4,)), ("TorusTopology", (2, 2)),
                                       ("OnePeerExponentialTopology", (4,))])
def test_controller_views_equal_the_reference(name, args):
    assert _script(swarm, getattr(topology, name), args) == _script(jswarm, getattr(jtopology, name), args)


def test_controller_keeps_the_lock_contract():
    assert swarm.MembershipController.__guarded_by__ == jswarm.MembershipController.__guarded_by__
    ctl = swarm.MembershipController(topology.RingTopology(2))
    ctl.propose_drop([0, 1])
    with pytest.raises(ValueError, match="no active member"):
        ctl.advance()


# ---------------------------------------------------------------------------
# gossip bootstrap
# ---------------------------------------------------------------------------

BOOT = [("ring", 6, 2, None, None), ("ring", 4, 1, 20, None), ("torus", 6, 2, None, None),
        ("onepeer-exp", 6, 2, None, None), ("ring", 6, 2, None, [1, 0, 1, 1, 1, 1])]


@pytest.mark.parametrize("name,world,n_new,rounds,alive", BOOT, ids=[f"{b[0]}-{i}" for i, b in enumerate(BOOT)])
def test_gossip_bootstrap_equals_the_reference(name, world, n_new, rounds, alive):
    rng = np.random.default_rng(world + n_new)
    tree = {"w": rng.normal(size=(world, 4, 3)).astype(np.float32), "b": rng.normal(size=(world, 3)).astype(np.float32)}
    jtopo = jtopology.topology_from_name(name, world + n_new)
    ptopo = topology.topology_from_name(name, world + n_new)
    jrows, jinfo = jswarm.gossip_bootstrap({k: jnp.asarray(v) for k, v in tree.items()}, jtopo, n_new, rounds=rounds,
                                           alive=alive)
    ptree = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    prows, pinfo = swarm.gossip_bootstrap(ptree, ptopo, n_new, rounds=rounds, alive=alive)
    assert pinfo["rounds"] == jinfo["rounds"] and pinfo["converged"] == jinfo["converged"]
    assert swarm.bootstrap_rounds_for(ptopo) == jswarm.bootstrap_rounds_for(jtopo)
    np.testing.assert_allclose(pinfo["eps_measured"], jinfo["eps_measured"], rtol=EPS_RTOL, atol=EPS_ATOL)
    for k in tree:
        np.testing.assert_allclose(prows[k].numpy(), np.asarray(jrows[k]), atol=ROW_ATOL, err_msg=k)
        np.testing.assert_array_equal(ptree[k].numpy(), tree[k])  # survivors untouched


# ---------------------------------------------------------------------------
# run_churn against the reference
# ---------------------------------------------------------------------------

CHURN_SPEC = "join@1:2;drop@2:3;straggle@3:5x2;rejoin@4:3"
CHURN_ROUNDS = 6


def _churn_pair(topo_name):
    """The reference's and the port's churn replay of ``CHURN_SPEC`` on
    ``mnist_mlp`` smoke at 4 workers, from the reference's initial state."""
    initial, capacity = 4, 6
    jbundle = jax_configs.build("mnist_mlp", "smoke", world=initial)
    jcap = jax_configs.build("mnist_mlp", "smoke", world=capacity)
    bundle = configs.build("mnist_mlp", "smoke", world=initial, device="cpu")
    cap = configs.build("mnist_mlp", "smoke", world=capacity, device="cpu")
    if topo_name is not None:
        jbundle.cfg = dataclasses.replace(jbundle.cfg, gossip=dataclasses.replace(
            jbundle.cfg.gossip, topology=jtopology.topology_from_name(topo_name, initial)))
        configs.with_topology(bundle, topo_name)
    schedule = swarm.ChurnSchedule.parse(CHURN_SPEC)
    jcfg = jswarm.churn_config(jbundle.cfg)
    want = jswarm.run_churn(jbundle.cfg, jbundle.loss_fn, jbundle.init_params, jswarm.ChurnSchedule.parse(CHURN_SPEC),
                            rounds=CHURN_ROUNDS, batches=lambda n, s: jcap.batches(n, s), seed=0)
    # the reference's initial state (its init_stacked_state of init_params)
    from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state

    jstate = jax_init_stacked_state(jcfg, jbundle.init_params, jax.random.key(0), initial)
    tree = jax.tree.map(np.asarray, jstate._replace(rng=None, outer=None))
    state = state_from_reference(tree, bundle, device="cpu")
    got = swarm.run_churn(bundle.cfg, bundle.loss_fn, (state.params, state.model_state), schedule, rounds=CHURN_ROUNDS,
                          batches=lambda n, s: cap.batches(n, s), seed=0)
    return got, want


@pytest.mark.parametrize("topo_name", [None, "ring"], ids=["dense", "ring"])
def test_run_churn_follows_the_reference(topo_name):
    got, want = _churn_pair(topo_name)
    assert len(got.losses) == len(want.losses) == CHURN_ROUNDS
    for r in range(CHURN_ROUNDS):
        assert abs(got.losses[r] - want.losses[r]) <= LOSS_ATOL, (r, got.losses, want.losses)
        assert abs(got.consensus_errors[r] - want.consensus_errors[r]) <= ERR_RTOL * want.consensus_errors[r] + 1e-7, (
            r, got.consensus_errors, want.consensus_errors)
    assert [(e["round"], e["kind"], e["workers"], e["epoch"]) for e in got.events] == [
        (e["round"], e["kind"], e["workers"], e["epoch"]) for e in want.events]
    assert got.world_trajectory == want.world_trajectory and got.alive_fracs == pytest.approx(want.alive_fracs)
    assert [b["rounds"] for b in got.bootstraps] == [b["rounds"] for b in want.bootstraps]
    assert all(b["eps_measured"] <= b["tol"] for b in got.bootstraps)
    assert got.recompiles == want.recompiles and got.final_view.epoch == want.final_view.epoch


def test_a_frozen_worker_is_bit_untouched_by_a_round():
    bundle = configs.build("mnist_mlp", "smoke", world=4, device="cpu")
    cfg = swarm.churn_config(bundle.cfg)
    params, model_state = configs.init_on_device(bundle, 0, "cpu")
    state = init_stacked_state(cfg, params, 4, model_state=model_state)
    before = {n: p.clone() for n, p in state.params.items()}
    step = make_simulated_train_step(cfg, bundle.loss_fn)
    batch = next(iter(bundle.batches(1, 0)))
    state, m = step(state, batch, [1.0, 0.0, 1.0, 1.0], [0.0, 1.0, 0.0, 0.0])
    assert m["alive_mask"].tolist() == [1.0, 0.0, 1.0, 1.0]
    for n, p in state.params.items():
        assert torch.equal(p[1], before[n][1]), n
        assert not torch.equal(p[0], before[n][0]), n
    assert cfg.gossip.faults == FaultConfig(drop_prob=0.0) and cfg.gossip.push_sum == "auto"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

REFUSED = [["--backend", "collective"], ["--drop-prob", "0.1"], ["--overlap-gossip"], ["--checkpoint-every", "2"],
           ["--eval-every", "2", "--eval-batches", "1"], ["--link-probes"], ["--round-timeout", "5"],
           ["--flight-recorder", "FR"], ["--profile-dir", "P"]]


@pytest.mark.parametrize("extra", REFUSED, ids=[r[0] for r in REFUSED])
def test_cli_churn_refusals_exit_2(extra, capsys):
    argv = ["--device", "cpu", "--config", "mnist_mlp", "--rounds", "6", "--churn-schedule", CHURN_SPEC, *extra]
    assert main(argv) == 2
    err = capsys.readouterr().err
    assert "--churn-schedule runs the simulated swarm loop and does not compose with " + extra[0] in err


@pytest.mark.parametrize("spec", ["rejoin@2:1", "drop@1:9"])
def test_cli_churn_bad_schedules_exit_2(spec, capsys):
    assert main(["--device", "cpu", "--config", "mnist_mlp", "--rounds", "6", "--churn-schedule", spec]) == 2
    assert "error: --churn-schedule: " in capsys.readouterr().err


def test_cli_churn_schedule_end_to_end(tmp_path, capsys):
    from consensusml_tpu_torch.tools import obs_report

    obs = str(tmp_path / "obs")
    argv = ["--device", "cpu", "--config", "mnist_mlp", "--rounds", str(CHURN_ROUNDS), "--churn-schedule", CHURN_SPEC,
            "--obs-cluster-dir", obs, "--telemetry-every", "1", "--checkpoint-dir", str(tmp_path / "ck"),
            "--eval-batches", "1", "--metrics-out", str(tmp_path / "m.jsonl")]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert f"churn schedule: {CHURN_SPEC}" in out
    assert "swarm: initial=4 capacity=6 joins=2 drops=1 rejoins=1 stragglers=1 push_sum='auto'" in out
    assert "[round 1] membership join: w4,5 (bootstrap " in out
    assert "[round 2] membership drop: w3" in out and "[round 4] membership rejoin: w3" in out
    assert "[round 3] membership straggle: w5 (2 rounds)" in out
    assert "swarm final: epoch=4 members=6 active / 6 slots, 1 gossip bootstraps (no checkpoint reads), " \
           "2 step rebuilds" in out
    assert "eval[mean-model]:" in out and "checkpoint: " in out
    with open(tmp_path / "m.jsonl") as f:
        assert [json.loads(line)["round"] for line in f] == list(range(CHURN_ROUNDS))
    assert obs_report.main([obs]) == 0
    text = capsys.readouterr().out
    assert "membership timeline (round : event):" in text
    for row in ("1 : + join     w4,w5", "2 : x drop     w3", "3 : ~ straggle w5  [2 rounds]", "4 : ^ rejoin   w3"):
        assert row in text, text
