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

The long-run flags act on every rank: the rebuilt optimizer and SlowMo
(:func:`~consensusml_tpu_torch.configs.with_train_flags`, the schedule
sized from ``spec["sched_start"]``, the checkpoint's round the parent
read), ``--resume`` (each rank reads its own worker's file), checkpoints
(each rank writes its own worker's file, then after a barrier rank 0 the
meta: the simulated backend's layout), the periodic and final held-out
eval (:func:`~consensusml_tpu_torch.train.evaluate.evaluate_collective`,
printed by rank 0), the watchdog (one a rank) and ``--metrics-out``
(rank 0's records).
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
    ``device``, every gossip and training flag applied as the CLI applies
    them."""
    from consensusml_tpu_torch import configs

    bundle = configs.build(
        spec["config"], spec["scale"], world=spec["workers"], codec=spec["codec"], gamma=spec["gamma"],
        codec_warmup=spec["codec_warmup"], norm_impl=spec["norm_impl"], device=device,
        data_dir=spec.get("data_dir"),
    )
    if spec["topology"] is not None:
        configs.with_topology(bundle, spec["topology"])
    configs.with_gossip_flags(
        bundle, drop_prob=spec.get("drop_prob", 0.0), push_sum=spec.get("push_sum", False),
        gossip_steps=spec.get("gossip_steps"), codec_refresh=spec.get("codec_refresh"),
        bucket_bytes=spec.get("bucket_bytes"), overlap=spec.get("overlap_gossip", False),
        pipeline=spec.get("gossip_pipeline"),
    )
    return configs.with_train_flags(
        bundle, lr=spec.get("lr"), lr_schedule=spec.get("lr_schedule"), warmup_rounds=spec.get("warmup_rounds", 0),
        grad_clip=spec.get("grad_clip", 0.0), slowmo_beta=spec.get("slowmo_beta"), rounds=spec["rounds"],
        sched_start=spec.get("sched_start", 0),
    )


def save_collective(path: str, state, mesh, step: int) -> str:
    """Every rank's worker file of the checkpoint ``path/step_N``, then,
    after a barrier, rank 0's meta: the simulated backend's layout.
    Synchronous, as the reference's multi-process save is."""
    from consensusml_tpu_torch.utils.checkpoint import save_state, write_meta

    dest = save_state(path, state, step=step, rank=mesh.rank)
    mesh.barrier()
    if mesh.rank == 0:
        write_meta(dest, mesh.world_size, state.step)
    mesh.barrier()
    return dest


def train_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of a CLI run: its worker's rounds. Returns per round the
    loss, consensus error, wire bytes, times and the kernel launches of
    that round (counters zeroed just before it), and the device's peak
    memory, the seconds of its setup (state built and restored) and of the
    whole run up to the check round; with an LR flag each round's ``lr``
    and with clipping its
    ``grad_norm`` (this rank's pre-clip norm) and ``clipped``; the eval
    results (``evals``, by round, ``None`` for the final one) and the
    last checkpoint's directory. ``spec["init"]``, when given, holds stacked numpy initial
    variables in flax layout (the config's ``init_params`` output; this
    rank takes its row); ``spec["return_params"]`` adds the final
    parameters as numpy; ``spec["check"]`` (``{"seed", "step", "leaves"}``,
    and ``"alive"``, a ``(world,)`` mask for that round) adds one gossip
    round on seeded inputs after training
    (:func:`~consensusml_tpu_torch.comm.check.seeded_gossip_round`)."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.comm.mesh import WorkerMesh, rank_device
    from consensusml_tpu_torch.train.evaluate import evaluate_collective
    from consensusml_tpu_torch.train.local_sgd import init_state, make_collective_train_step, rank_batch
    from consensusml_tpu_torch.train.run import due, eval_text, extras_text, start_watchdog, train_extras
    from consensusml_tpu_torch.utils import tree as T
    from consensusml_tpu_torch.utils.checkpoint import restore_state
    from consensusml_tpu_torch.utils.logging import MetricsLogger

    t_entry = time.perf_counter()
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
    del params, model_state
    if spec.get("resume"):
        state = restore_state(spec["resume"], state, rank=rank)
        if rank == 0:
            print(f"resumed from {spec['resume']} at round {state.step}", flush=True)
    start = state.step
    end = start + spec["rounds"]
    setup_s = time.perf_counter() - t_entry
    step = make_collective_train_step(bundle.cfg, bundle.loss_fn, mesh)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    evals: dict = {}

    def run_eval(rnd):
        result = evaluate_collective(bundle.eval_fn, state, bundle.eval_batches(spec["eval_batches"], spec["seed"]),
                                     mesh)
        evals[rnd] = result
        if rank == 0:
            print(eval_text(result, rnd), flush=True)

    watchdog = start_watchdog(spec.get("round_timeout", 0.0))
    logger = MetricsLogger(spec.get("metrics_out") if rank == 0 else None)
    ckpt_dir, last_saved, ckpt_path = spec.get("checkpoint_dir"), None, None
    rounds = []
    for i, batch in enumerate(bundle.batches(spec["rounds"], spec["seed"], start=start)):
        r = start + i
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, rank_batch(batch, rank))
        loss, err = float(m["loss"]), float(m["consensus_error"])
        ms = 1e3 * (time.perf_counter() - t0)
        extras = train_extras(spec, bundle.cfg.optimizer, state.opt_state)
        # every rank's times and pre-clip norm, in one row each of a (world, 5) sum
        row = torch.zeros((world, 5), dtype=torch.float32, device=device)
        row[rank] = torch.tensor([ms, m["staging_ms"], m["wire_ms"], m.get("imgs_per_s", 0.0),
                                  extras.get("grad_norm", 0.0)])
        table = mesh.transport.all_reduce_sum([row])[0].cpu()
        # the line's norm as the simulated backend's: the largest over the workers
        line_extras = dict(extras)
        if "grad_norm" in extras:
            norms = table[:, 4].numpy()
            line_extras.update(grad_norm=float(norms.max()), clipped=int((norms >= spec["grad_clip"]).sum()))
        rounds.append({"loss": loss, "consensus_error": err, "round_ms": ms, "inner_ms": m["inner_ms"],
                       "gossip_ms": m["gossip_ms"], "metrics_ms": m["metrics_ms"], "wire_bytes": m["wire_bytes"],
                       **{k: m[k] for k in ("gossip_issue_ms", "gossip_wait_ms") if k in m},
                       "bytes_staged": m["bytes_staged"],
                       "staging_ms": m["staging_ms"], "wire_ms": m["wire_ms"],
                       "launches": {k: v for k, v in kernels.launch_counts().items() if v},
                       "forms": kernels.form_counts(),
                       **({"alive_frac": float(m["alive_frac"]), "alive_mask": m["alive_mask"].tolist()}
                          if "alive_frac" in m else {}), **extras})
        log_every = spec["log_every"]
        if rank == 0 and log_every and (r % log_every == 0 or r == end - 1):
            imgs = f" imgs/s {float(table[:, 3].sum()):.1f}" if "imgs_per_s" in m else ""
            alive = f" alive_frac {float(m['alive_frac']):.4g}" if "alive_frac" in m else ""
            fmt = lambda col: "[" + ", ".join(f"{v:.1f}" for v in table[:, col].tolist()) + "]"  # noqa: E731
            print(f"round {r}: loss {loss:.4f} consensus_error {err:.6g} round_ms {ms:.1f}{imgs}{alive} "
                  f"wire_bytes {m['wire_bytes']} ranks_round_ms {fmt(0)} staging_ms {fmt(1)} wire_ms {fmt(2)}"
                  f"{extras_text(line_extras)}", flush=True)
            logger.log(r, {"loss": loss, "consensus_error": err, "round_ms": ms, "wire_bytes": m["wire_bytes"],
                           **line_extras, **({"alive_frac": float(m["alive_frac"])} if "alive_frac" in m else {})})
        if watchdog is not None:
            watchdog.beat(f"round {r}")
        if due(spec.get("eval_every", 0), r) and r + 1 != end:
            if watchdog is not None:
                watchdog.pause()  # an eval has no per-round budget
            run_eval(r)
            if watchdog is not None:
                watchdog.beat(f"eval done @ round {r}")
        if ckpt_dir and due(spec.get("checkpoint_every") or 0, r):
            ckpt_path, last_saved = save_collective(ckpt_dir, state, mesh, r + 1), r + 1
    logger.close()
    if ckpt_dir and last_saved != end:
        ckpt_path = save_collective(ckpt_dir, state, mesh, end)
    if watchdog is not None:
        watchdog.stop()
    if ckpt_dir and rank == 0:
        print(f"checkpoint: {ckpt_path}", flush=True)
    if spec.get("eval_batches", 0) > 0:
        run_eval(None)
    engine = bundle.cfg.engine()
    gossiped = {"params": {n: p[0] for n, p in state.params.items()},
                "model_state": T.tree_map(lambda t: t[0], state.model_state)}
    plan = engine.bucket_plan(gossiped)
    out = {"rank": rank, "rounds": rounds, "buckets": None if plan is None else plan.num_buckets,
           "wire_bytes_per_round": engine.wire_bytes_per_round(gossiped), "evals": evals, "checkpoint": ckpt_path,
           "setup_s": setup_s, "seconds": time.perf_counter() - t_entry}
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
