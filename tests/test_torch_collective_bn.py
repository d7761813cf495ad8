"""The BN running statistics under collective and simulated gossip, in
both packages.

On the card, 8 ranks resuming ``cifar_resnet50`` end with BN running
means up to 8.3x ``COLLECTIVE_ATOL`` (1e-6) away, element by element, from
the simulated continuation. This holds the gossip itself to the
reference: the BN statistics of ``cifar_resnet50`` smoke (the small
ResNet of the config, 8 workers, its ring and its exact bucketed gossip),
drawn as a trained run holds them (running means near 0, variances near
1), through three chained rounds of

- the reference's collective round under ``shard_map`` on the 8 virtual
  CPU devices and its jitted simulated round;
- the port's collective round (8 ``gloo`` ranks on the CPU) and its
  simulated round.

The port's collective round equals the reference's bit for bit, and its
simulated round the reference's. The collective and simulated rounds
differ from each other by the same elements in both packages (a
neighbour sum against a matrix product): the drift is a property of the
two backends of the reference, which the port reproduces, not a fault of
the port's collective round. The test states that difference against
``COLLECTIVE_ATOL``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from consensusml_tpu.analysis.jaxpr_contracts import _shard_map_no_check
from consensusml_tpu.comm import WorkerMesh as JaxMesh
from consensusml_tpu.comm import simulated as jax_simulated
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.comm import check, simulated
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
from consensusml_tpu_torch.topology import topology_from_name
from consensusml_tpu_torch.utils import tree as T

WORLD = 8
ROUNDS = [0, 1, 2]
COLLECTIVE_ATOL = 1e-6  # chip_smoke.py's element-wise tolerance of the resumed statistics


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats():
    """The smoke ResNet's BN statistics, stacked over the workers, flat
    dotted paths: running means N(0, 1e-3), variances U(0.5, 2)."""
    bundle = configs.build("cifar_resnet50", "smoke", world=WORLD, device="cpu")
    flat = dict(T.flatten_with_paths(bundle.init_params(0)["batch_stats"]))
    rng = np.random.default_rng(21)
    out = {}
    for path, a in sorted(flat.items()):
        name = ".".join(path)
        if name.endswith("mean"):
            out[name] = rng.normal(0.0, 1e-3, size=a.shape).astype(np.float32)
        else:
            out[name] = rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
    return out, bundle.cfg.gossip


def _nest(flat):
    """Dotted paths -> the reference's nested ``batch_stats`` dict."""
    out: dict = {}
    for name, a in flat.items():
        *head, leaf = name.split(".")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[leaf] = a
    return out


def _flat(nested, prefix=""):
    out = {}
    for k, v in nested.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _results():
    stats, gossip = _stats()
    jeng = JaxEngine(JaxGossip(topology=jax_topology(gossip.topology.name, WORLD),
                               bucket_bytes=gossip.bucket_bytes))
    teng = ConsensusEngine(GossipConfig(topology=topology_from_name(gossip.topology.name, WORLD),
                                        bucket_bytes=gossip.bucket_bytes))
    tree = {"params": {}, "model_state": {"batch_stats": _nest(stats)}}

    # the reference's collective rounds, one jitted shard_map round at a time
    wm = JaxMesh.create(jeng.topology, platform="cpu")
    spec = P(*jeng.topology.axis_names)

    @jax.jit
    @functools.partial(_shard_map_no_check, mesh=wm.mesh, in_specs=(spec, P()), out_specs=spec)
    def coll_round(t, step):
        t = jax.tree.map(lambda x: x[0], t)
        t, _ = jeng.round_collective(t, None, step=step)
        return jax.tree.map(lambda x: x[None], t)

    ref_coll = tree
    for step in ROUNDS:
        ref_coll = jax.tree.map(np.asarray,
                                coll_round(jax.device_put(ref_coll, wm.worker_sharding()), jnp.int32(step)))
    w = jax_simulated.mixing_matrix(jeng.topology)
    sim_round = jax.jit(lambda t: jeng.round_simulated(t, None, w)[0])
    ref_sim = tree
    for _ in ROUNDS:
        ref_sim = jax.tree.map(np.asarray, sim_round(ref_sim))

    port_tree = {"params": {}, "model_state": {"batch_stats": dict(stats)}}
    got = launch(check.gossip_cases, WORLD, [(teng, port_tree, ROUNDS, None)], "gloo", "cpu", timeout=120.0)
    port_coll = {k: np.stack([g[0]["tree"]["model_state"]["batch_stats"][k] for g in got]) for k in stats}
    x = T.tree_map(torch.from_numpy, port_tree)
    wt = simulated.mixing_matrix(teng.topology)
    for step in ROUNDS:
        x, _ = teng.round_simulated(x, None, wt, step=step)
    port_sim = {k: v.numpy() for k, v in x["model_state"]["batch_stats"].items()}
    return (stats, _flat(ref_coll["model_state"]["batch_stats"]), _flat(ref_sim["model_state"]["batch_stats"]),
            port_coll, port_sim)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", ["mean", "var"])
def test_port_collective_bn_rounds_equal_the_reference_bit_for_bit(kind):
    stats, ref_coll, _ref_sim, port_coll, _port_sim = _results()
    names = [k for k in stats if k.endswith(kind)]
    assert names and set(ref_coll) == set(stats)
    for k in names:
        np.testing.assert_array_equal(_bits(port_coll[k]), _bits(ref_coll[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["mean", "var"])
def test_port_simulated_bn_rounds_equal_the_reference_bit_for_bit(kind):
    stats, _ref_coll, ref_sim, _port_coll, port_sim = _results()
    for k in [k for k in stats if k.endswith(kind)]:
        np.testing.assert_array_equal(_bits(port_sim[k]), _bits(ref_sim[k]), err_msg=k)


def test_collective_and_simulated_bn_drift_is_the_references_own():
    """Collective against simulated: the same elements differ by the same
    amounts in both packages, within a few ulps of the statistics' scale
    (the means near 0 see an absolute gap of that size; the numbers are
    printed for the known limits)."""
    stats, ref_coll, ref_sim, port_coll, port_sim = _results()
    for k in stats:
        np.testing.assert_array_equal(port_coll[k] - port_sim[k], ref_coll[k] - ref_sim[k], err_msg=k)
    means = [k for k in stats if k.endswith("mean")]
    gap = max(float(np.max(np.abs(ref_coll[k] - ref_sim[k]))) for k in means)
    scale = max(float(np.max(np.abs(stats[k]))) for k in means)
    diff = sum(int(np.count_nonzero(ref_coll[k] != ref_sim[k])) for k in means)
    total = sum(stats[k].size for k in means)
    print(f"BN means after {len(ROUNDS)} rounds: collective vs simulated max |gap| {gap:.3e} "
          f"({gap / COLLECTIVE_ATOL:.4f} x COLLECTIVE_ATOL), {diff} of {total} elements differ, "
          f"max |mean| {scale:.3e}")
    assert gap <= 8 * np.finfo(np.float32).eps * scale
