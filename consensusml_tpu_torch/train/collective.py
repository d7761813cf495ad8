"""The train CLI's collective backend: one process per worker.

:func:`run` checks the flags, builds the CUDA kernels in the parent (so
the ranks only load them), spawns the ranks through
:func:`consensusml_tpu_torch.comm.launch.launch` and returns their
summaries. Each rank (:func:`train_rank`) draws its own worker's initial
parameters (the simulated backend's row ``rank``), takes its row of each
stacked round batch, and steps with
:func:`~consensusml_tpu_torch.train.local_sgd.make_collective_train_step`.
Rank 0 prints one line a logged round: the all-reduced loss and
consensus error, then every rank's round, staging and wire milliseconds
(gathered by one small all-reduce after the round's own traffic).
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["check_flags", "run", "spec_bundle", "train_rank", "train_runs"]


def check_flags(device: str, dist_backend: str, world: int, device_count: int) -> None:
    """Refuse what the transport cannot do: NCCL on the CPU, or NCCL with
    more ranks than cards."""
    from consensusml_tpu_torch.comm.transport import DIST_BACKENDS, check_nccl_world

    if dist_backend not in DIST_BACKENDS:
        raise ValueError(f"unknown --dist-backend {dist_backend!r} (one of {DIST_BACKENDS})")
    if dist_backend == "nccl":
        if device == "cpu":
            raise ValueError("--dist-backend nccl moves CUDA tensors only; use --dist-backend gloo with --device cpu")
        check_nccl_world(world, device_count)


def run(spec: dict, world: int) -> list[dict]:
    """Spawn ``world`` ranks of :func:`train_rank` over ``spec`` (the
    parsed flags as a dict) and return their summaries. No wall-clock
    limit: a rank that raises or dies, or a peer stalled past the process
    group's own timeout, fails the run."""
    from consensusml_tpu_torch.comm.launch import launch
    from consensusml_tpu_torch.device import resolve_device

    if spec["device"] != "cpu":
        resolve_device(spec["device"])  # raises without a GPU
    count = torch.cuda.device_count() if spec["device"] != "cpu" else 0
    check_flags(spec["device"], spec["dist_backend"], world, count)
    if spec["device"] != "cpu":
        from consensusml_tpu_torch import kernels

        kernels.build()
    return launch(train_rank, world, spec, dist_backend=spec["dist_backend"])


def spec_bundle(spec: dict, device):
    """The run bundle of ``spec`` (the parsed flags as a dict) on
    ``device``, every gossip flag applied as the CLI applies it."""
    from consensusml_tpu_torch import configs

    bundle = configs.build(
        spec["config"], spec["scale"], world=spec["workers"], codec=spec["codec"], gamma=spec["gamma"],
        codec_warmup=spec["codec_warmup"], norm_impl=spec["norm_impl"], device=device,
    )
    if spec["topology"] is not None:
        configs.with_topology(bundle, spec["topology"])
    return configs.with_gossip_flags(
        bundle, drop_prob=spec.get("drop_prob", 0.0), push_sum=spec.get("push_sum", False),
        gossip_steps=spec.get("gossip_steps"), codec_refresh=spec.get("codec_refresh"),
        bucket_bytes=spec.get("bucket_bytes"), overlap=spec.get("overlap_gossip", False),
        pipeline=spec.get("gossip_pipeline"),
    )


def train_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of a CLI run: its worker's rounds. Returns per round the
    loss, consensus error, wire bytes, times and the kernel launches of
    that round (counters zeroed just before it), and the device's peak
    memory. ``spec["init"]``, when given, holds stacked numpy initial
    variables in flax layout (the config's ``init_params`` output; this
    rank takes its row); ``spec["return_params"]`` adds the final
    parameters as numpy; ``spec["check"]`` (``{"seed", "step", "leaves"}``,
    and ``"alive"``, a ``(world,)`` mask for that round) adds one gossip
    round on seeded inputs after training
    (:func:`~consensusml_tpu_torch.comm.check.seeded_gossip_round`)."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.comm.mesh import WorkerMesh, rank_device
    from consensusml_tpu_torch.train.local_sgd import init_state, make_collective_train_step, rank_batch
    from consensusml_tpu_torch.utils import tree as T

    device = rank_device(rank, spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    bundle = spec_bundle(spec, device)
    mesh = WorkerMesh.create(bundle.cfg.gossip.topology, spec["dist_backend"], device)
    init = spec.get("init")
    if init is None:
        init = bundle.init_params(spec["seed"], ranks=[rank])
    else:
        init = T.tree_map(lambda a: np.ascontiguousarray(a[rank: rank + 1]), init)
    params, model_state = bundle.convert(init)
    params = {n: t[0].to(device) for n, t in params.items()}
    model_state = T.tree_map(lambda t: t[0].to(device), model_state)
    frozen = configs.frozen_on_device(bundle, device)
    state = init_state(bundle.cfg, params, rank, seed=spec["seed"], model_state=model_state, frozen=frozen)
    step = make_collective_train_step(bundle.cfg, bundle.loss_fn, mesh)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rounds = []
    for r, batch in enumerate(bundle.batches(spec["rounds"], spec["seed"])):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, rank_batch(batch, rank))
        loss, err = float(m["loss"]), float(m["consensus_error"])
        ms = 1e3 * (time.perf_counter() - t0)
        # every rank's times, in one row each of a (world, 4) sum
        row = torch.zeros((world, 4), dtype=torch.float32, device=device)
        row[rank] = torch.tensor([ms, m["staging_ms"], m["wire_ms"], m.get("imgs_per_s", 0.0)])
        table = mesh.transport.all_reduce_sum([row])[0].cpu()
        rounds.append({"loss": loss, "consensus_error": err, "round_ms": ms, "inner_ms": m["inner_ms"],
                       "gossip_ms": m["gossip_ms"], "metrics_ms": m["metrics_ms"], "wire_bytes": m["wire_bytes"],
                       **{k: m[k] for k in ("gossip_issue_ms", "gossip_wait_ms") if k in m},
                       "bytes_staged": m["bytes_staged"],
                       "staging_ms": m["staging_ms"], "wire_ms": m["wire_ms"],
                       "launches": {k: v for k, v in kernels.launch_counts().items() if v},
                       "forms": kernels.form_counts(),
                       **({"alive_frac": float(m["alive_frac"]), "alive_mask": m["alive_mask"].tolist()}
                          if "alive_frac" in m else {})})
        log_every = spec["log_every"]
        if rank == 0 and log_every and (r % log_every == 0 or r == spec["rounds"] - 1):
            imgs = f" imgs/s {float(table[:, 3].sum()):.1f}" if "imgs_per_s" in m else ""
            alive = f" alive_frac {float(m['alive_frac']):.4g}" if "alive_frac" in m else ""
            fmt = lambda col: "[" + ", ".join(f"{v:.1f}" for v in table[:, col].tolist()) + "]"  # noqa: E731
            print(f"round {r}: loss {loss:.4f} consensus_error {err:.6g} round_ms {ms:.1f}{imgs}{alive} "
                  f"wire_bytes {m['wire_bytes']} ranks_round_ms {fmt(0)} staging_ms {fmt(1)} wire_ms {fmt(2)}",
                  flush=True)
    engine = bundle.cfg.engine()
    gossiped = {"params": {n: p[0] for n, p in state.params.items()},
                "model_state": T.tree_map(lambda t: t[0], state.model_state)}
    plan = engine.bucket_plan(gossiped)
    out = {"rank": rank, "rounds": rounds, "buckets": None if plan is None else plan.num_buckets,
           "wire_bytes_per_round": engine.wire_bytes_per_round(gossiped)}
    del gossiped
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
        out["device_used_bytes"] = total - free  # every process on the card
    from consensusml_tpu_torch.comm.check import seeded_gossip_round, to_numpy

    if spec.get("return_params"):
        out["params"] = to_numpy({n: p[0] for n, p in state.params.items()})
        out["model_state"] = to_numpy(T.tree_map(lambda t: t[0], state.model_state))
    if spec.get("check"):
        shapes = [(path, tuple(t.shape[1:])) for path, t in T.flatten_with_paths(
            {"params": state.params, "model_state": state.model_state})]
        del state, step
        if device.type == "cuda":
            torch.cuda.empty_cache()
        c = spec["check"]
        leaves = shapes if c.get("leaves") is None else shapes[: c["leaves"]]
        out["check"] = seeded_gossip_round(mesh, engine, leaves, c["seed"], c["step"], c.get("alive"))
    return out


def train_runs(rank: int, world: int, specs: list[dict]) -> list[dict]:
    """:func:`train_rank` for each spec in turn, in one process group (the
    card's cached blocks released between runs)."""
    out = []
    for spec in specs:
        out.append(train_rank(rank, world, spec))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out
