"""``python -m consensusml_tpu_torch.train``: consensus-SGD training of the
port, mirroring ``train.py``'s flags for the slices that are ported, on
the simulated backend (every worker stacked on one device) or the
collective one (``--backend collective``: one process per worker, the
gossip over ``torch.distributed``; ``--dist-backend gloo`` stages the
wire through pinned host memory and runs any number of ranks on one
card or on the CPU, ``--dist-backend nccl`` needs a card per rank):
``gpt2_topk`` (on its own codec, ``--codec
topk_int4``, or ``--codec int8|int4|fp8`` on the fused wire;
``--norm-impl pallas`` runs every LayerNorm through the fused-LN CUDA
kernels), ``cifar_resnet50``
(exact gossip; ``--norm-impl pallas`` runs every BN through the fused-BN
CUDA kernels), ``mnist_mlp`` (the 2-layer MLP, dense exact gossip) and
``bert_mlm`` (BERT masked-LM, 8 local Adam steps a round, exact ring
gossip; ``--eval-batches`` scores the masked positions' accuracy and nll)
and ``llama_lora`` (a LoRA fine-tune of Llama, Llama-2-7B at full scale:
the base held once and frozen, the adapters trained by Adam and gossiped
exactly on a torus, alone on the wire).
``--topology NAME[:k=v,...]`` swaps any config's gossip graph (ring,
torus, dense, exp, onepeer-exp, hierarchical:slices=S,outer_every=K);
``--drop-prob P`` injects worker drop-outs (each worker misses a round
with probability P, and a worker whose local steps go non-finite is
rolled back and dead for the round), ``--push-sum`` gossips by ratio
consensus (exact on directed graphs and under faults; exact configs
only), ``--bucket-bytes N`` caps the wire's buckets (0: the per-leaf
wire), ``--gossip-steps T`` runs T consensus iterations a round and
``--codec-refresh K`` a dense round every K on a compressed config;
``--overlap-gossip`` computes each round's mixing correction from the
params before the local steps and applies it a round later (on the
collective backend its exchange runs under the local steps), and
``--gossip-pipeline D`` keeps D corrections in flight;
``--eval-batches N`` scores N held-out batches after the last round, for
the mean model and the workers (top-1, or the LM's nll and perplexity),
and ``--eval-every K`` every K rounds as well, on both backends.

Runs that last (the reference's ``train.py`` flags, with its meanings,
defaults and exit code 2 on a bad combination): ``--lr`` overrides the
config's peak rate, ``--lr-schedule {constant,cosine,linear}`` with
``--warmup-rounds`` schedules it over the optimizer steps of the
checkpoint's round plus ``--rounds`` (``train/schedules.py``),
``--grad-clip`` clips each worker's gradients by their global norm,
``--slowmo-beta`` adds the SlowMo outer step (``train/outer.py``; a
warning from 0.4 up), ``--checkpoint-dir`` with ``--checkpoint-every``
saves the whole state every K rounds and at the end (``utils/checkpoint.py``;
``--resume DIR/step_N`` continues from one, bit for bit, on either
backend; its world size must be the run's: elastic resize is not ported),
``--round-timeout S`` hard-exits with code 3 when a round makes no
progress for S seconds (``utils/watchdog.py``; armed after the first
round, paused during an eval), ``--data-dir`` trains on MNIST, CIFAR-10 or
token files (``data/files.py``) and ``--metrics-out PATH`` appends one JSON
record a logged round (``utils/logging.py``)::

    python -m consensusml_tpu_torch.train --scale smoke --device cpu --rounds 3
    python -m consensusml_tpu_torch.train --scale full --workers 4 --codec-warmup 1
    python -m consensusml_tpu_torch.train --scale full --workers 4 --codec-warmup 1 --codec int8
    python -m consensusml_tpu_torch.train --scale full --workers 4 --codec-warmup 1 --codec int4
    python -m consensusml_tpu_torch.train --scale full --workers 4 --codec-warmup 1 --codec fp8
    python -m consensusml_tpu_torch.train --scale full --workers 4 --codec-warmup 1 --codec topk_int4 --norm-impl pallas
    python -m consensusml_tpu_torch.train --config cifar_resnet50 --scale full [--norm-impl pallas]
    python -m consensusml_tpu_torch.train --config mnist_mlp --scale full --rounds 50 --eval-batches 8
    python -m consensusml_tpu_torch.train --config mnist_mlp --topology onepeer-exp --eval-batches 8
    python -m consensusml_tpu_torch.train --config bert_mlm --device cpu --rounds 3 --eval-batches 2
    python -m consensusml_tpu_torch.train --config bert_mlm --scale full --rounds 3 --eval-batches 8
    python -m consensusml_tpu_torch.train --config llama_lora --device cpu --rounds 3 --eval-batches 2
    python -m consensusml_tpu_torch.train --config llama_lora --scale full --rounds 3 --eval-batches 1
    python -m consensusml_tpu_torch.train --config cifar_resnet50 --scale full --norm-impl pallas --drop-prob 0.1
    python -m consensusml_tpu_torch.train --config cifar_resnet50 --scale full --topology onepeer-exp --push-sum \
        --drop-prob 0.1
    python -m consensusml_tpu_torch.train --scale full --workers 4 --bucket-bytes 0
    python -m consensusml_tpu_torch.train --config mnist_mlp --device cpu --overlap-gossip --gossip-pipeline 2
    python -m consensusml_tpu_torch.train --scale full --workers 4 --codec-warmup 0 --codec-refresh 0 \
        --overlap-gossip --gossip-pipeline 2
    python -m consensusml_tpu_torch.train --config mnist_mlp --scale smoke --device cpu --backend collective \
        --dist-backend gloo --workers 4 --rounds 2
    python -m consensusml_tpu_torch.train --config cifar_resnet50 --scale full --norm-impl pallas \
        --backend collective --dist-backend gloo
    python -m consensusml_tpu_torch.train --config mnist_mlp --device cpu --rounds 4 --lr-schedule cosine \
        --warmup-rounds 1 --grad-clip 1.0 --slowmo-beta 0.2 --checkpoint-dir D --checkpoint-every 2 \
        --eval-batches 2 --eval-every 2
    python -m consensusml_tpu_torch.train --config mnist_mlp --device cpu --rounds 2 --lr-schedule cosine \
        --warmup-rounds 1 --grad-clip 1.0 --slowmo-beta 0.2 --resume D/step_2 --eval-batches 2

Runs on the card unless ``--device cpu`` is given (no CPU fallback). The
simulated backend draws and uploads the initial parameters a worker at a
time (``configs.init_on_device``).
Prints the resolved codec path and wire and the norm path, then
one line per logged round: loss, consensus error, the round's wall time,
for image batches images per second and, with faults, the share of
workers alive in the round, with an LR flag the step's learning rate and
with clipping the largest pre-clip gradient norm over the workers; the
collective backend's lines come from rank 0 and add the round's wire
bytes and every rank's round, staging and wire milliseconds. A failing
rank fails the run (exit code 3 when a rank's watchdog fired).
"""


from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m consensusml_tpu_torch.train", description=__doc__.split("\n")[0])
    p.add_argument("--config", default="gpt2_topk",
                   choices=["gpt2_topk", "cifar_resnet50", "mnist_mlp", "bert_mlm", "llama_lora"])
    p.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    p.add_argument("--workers", type=int, default=None,
                   help="world size (default: the config's, or the --resume checkpoint's)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--codec", default=None, choices=["topk_int8", "topk_int4", "int8", "int4", "fp8"],
                   help="default: the config's own (topk_int8: chunked top-k + int8 on the two-step "
                        "bucketed wire); topk_int4: the same top-k with int4 values; int8, int4, fp8: "
                        "the per-chunk quantizer of that format on the fused one-pass wire")
    p.add_argument("--codec-warmup", type=int, default=None,
                   help="exact warm-up rounds (default: the config's)")
    p.add_argument("--gamma", type=float, default=None, help="CHOCO consensus step (default: the config's)")
    p.add_argument("--norm-impl", default="flax", choices=["flax", "pallas"],
                   help="the model's norm layers: flax = flax's LayerNorm (gpt2_topk) or PyTorch's batch "
                        "norm (cifar_resnet50), the configs' default; pallas = the fused-LN or fused-BN "
                        "CUDA kernels")
    p.add_argument("--topology", default=None,
                   help='override the config\'s gossip graph: "ring", "torus", "dense", "exp", '
                        '"onepeer-exp", or with integer args e.g. "torus:rows=2", '
                        '"hierarchical:slices=2,outer_every=4"')
    p.add_argument("--eval-batches", type=int, default=0,
                   help="after training, score this many held-out batches (the mean model's and the "
                        "workers' top-1, or the LM's nll and perplexity)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="also run the held-out eval every K rounds during training (requires --eval-batches)")
    p.add_argument("--drop-prob", type=float, default=0.0,
                   help="per-round worker drop-out probability (fault injection; non-finite failure "
                        "detection and rollback are enabled alongside it)")
    p.add_argument("--push-sum", action="store_true",
                   help="ratio-consensus averaging (exact mean on directed topologies and under faults; "
                        "exact-gossip configs only)")
    p.add_argument("--bucket-bytes", type=int, default=None,
                   help="gossip wire bucket cap in bytes (default 4 MiB); 0 = the per-leaf wire")
    p.add_argument("--gossip-steps", type=int, default=None,
                   help="consensus iterations per round (wire x N)")
    p.add_argument("--codec-refresh", type=int, default=None,
                   help="dense refresh round every K rounds on a compressed config")
    p.add_argument("--overlap-gossip", action="store_true",
                   help="combine-then-adapt gossip: the mixing correction is computed from the params before "
                        "the local steps and applied next round (on the collective backend its exchange runs "
                        "under the local steps); exact gossip, or compressed gossip on the bucketed wire")
    p.add_argument("--gossip-pipeline", type=int, default=None, metavar="D",
                   help="pipelined overlap gossip: D mixing corrections in flight (needs --overlap-gossip); "
                        "D=1 is --overlap-gossip alone")
    p.add_argument("--slowmo-beta", type=float, default=None,
                   help="enable the SlowMo outer optimizer with this slow-momentum decay (e.g. 0.8); default off")
    p.add_argument("--data-dir", default=None,
                   help="train on real files from this directory (MNIST idx / CIFAR-10 binaries / tokens.bin); "
                        "falls back to procedural data when absent")
    p.add_argument("--lr", type=float, default=None, help="override the config's peak learning rate")
    p.add_argument("--lr-schedule", default=None, choices=["constant", "cosine", "linear"],
                   help="LR schedule over --rounds (steps = rounds x h)")
    p.add_argument("--warmup-rounds", type=int, default=0, help="linear LR warmup, in gossip rounds")
    p.add_argument("--grad-clip", type=float, default=0.0, help="global-norm gradient clipping (0 = off)")
    p.add_argument("--round-timeout", type=float, default=0.0,
                   help="seconds without round progress before the process hard-exits (code 3) with a "
                        "diagnostic (a dead peer wedges survivors inside a collective otherwise); arms after "
                        "the first completed round; 0 = disabled")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0, help="rounds; 0 = end only")
    p.add_argument("--resume", default=None, help="checkpoint path to resume from (DIR/step_N)")
    p.add_argument("--metrics-out", default=None, help="JSONL metrics path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default="simulated", choices=["simulated", "collective"],
                   help="simulated: every worker stacked on one device; collective: one process per worker")
    p.add_argument("--dist-backend", default="gloo", choices=["nccl", "gloo"],
                   help="the collective backend's transport: gloo stages CUDA tensors through pinned host "
                        "memory (any number of ranks a card, or the CPU); nccl needs one card per rank")
    return p.parse_args(argv)


def _describe(bundle, engine, config: str) -> None:
    wire = "bucketed wire" if engine.bucketed else "per-leaf wire"
    cfg = bundle.cfg.gossip
    extra = "".join([", push-sum" if cfg.push_sum_enabled else "",
                     f", faults drop_prob={cfg.faults.drop_prob}" if cfg.faults is not None else "",
                     f", overlap gossip (pipeline depth {cfg.pipeline_depth})" if cfg.overlap else ""])
    if engine.compressed:
        fused = engine.fused_wire_active
        wire = "fused one-pass bucketed wire" if fused else ("two-step " + wire if engine.bucketed else wire)
        print(f"codec: {bundle.codec_path}; {wire} "
              f"(fused_wire={cfg.fused_wire}, active={fused}){extra}", flush=True)
    else:
        print(f"codec: {bundle.codec_path}; dense {wire}{extra}", flush=True)
    if bundle.norm_path:
        label = {"cifar_resnet50": "BN", "llama_lora": "norm"}.get(config, "LN")
        print(f"{label}: {bundle.norm_path}", flush=True)


def _describe_training(args, bundle) -> None:
    """One line for the long-run flags, when any is given."""
    from consensusml_tpu_torch.train.run import lr_flags_set

    parts = []
    if args.data_dir is not None:
        parts.append(f"data {bundle.data_source}")
    if lr_flags_set(vars(args)):
        lr = bundle.base_lr if args.lr is None else args.lr
        parts.append(f"lr {args.lr_schedule or 'constant'} peak {lr:g}, warmup {args.warmup_rounds} rounds, "
                     f"h {bundle.cfg.h}")
    if args.grad_clip > 0:
        parts.append(f"grad clip {args.grad_clip:g}")
    if bundle.cfg.outer is not None:
        parts.append(f"SlowMo beta {bundle.cfg.outer.beta:g} alpha {bundle.cfg.outer.alpha:g}")
    if args.checkpoint_dir is not None:
        parts.append(f"checkpoints {args.checkpoint_dir} every {args.checkpoint_every or 'end'}")
    if parts:
        print("training: " + "; ".join(parts), flush=True)


def _resume_plan(args) -> tuple[int | None, int, str | None]:
    """``(world, schedule start round, error)`` for ``--resume``: the
    checkpoint's world size (which ``--workers`` must equal) and round."""
    from consensusml_tpu_torch.utils.checkpoint import checkpoint_round, checkpoint_world_size

    if args.resume is None:
        return args.workers, 0, None
    world = checkpoint_world_size(args.resume)
    if world is None:
        return None, 0, f"error: cannot restore {args.resume}: no cml_meta.json (not a checkpoint of this trainer)"
    if args.workers is not None and args.workers != world:
        return None, 0, (f"error: --resume {args.resume} holds {world} workers but --workers is {args.workers}: "
                         "resuming at another world size (elastic resize) is not ported yet")
    return world, checkpoint_round(args.resume) or 0, None


def _bundle(args, dev, world, sched_start):
    """The run's bundle with every flag applied, or an ``error: ...`` line
    for what the CLI refuses with exit code 2."""
    from consensusml_tpu_torch import configs

    try:
        bundle = configs.build(
            args.config, args.scale, world=world, codec=args.codec, gamma=args.gamma,
            codec_warmup=args.codec_warmup, norm_impl=args.norm_impl, device=dev, data_dir=args.data_dir,
        )
    except ValueError as e:  # e.g. a token file whose ids do not fit the vocabulary
        return None, f"error: {e}"
    if args.topology is not None:
        try:
            configs.with_topology(bundle, args.topology)
        except (IndexError, ValueError) as e:
            return None, f"error: bad --topology {args.topology!r}: {e}"
    try:
        configs.with_gossip_flags(bundle, drop_prob=args.drop_prob, push_sum=args.push_sum,
                                  gossip_steps=args.gossip_steps, codec_refresh=args.codec_refresh,
                                  bucket_bytes=args.bucket_bytes, overlap=args.overlap_gossip,
                                  pipeline=args.gossip_pipeline)
        configs.with_train_flags(bundle, lr=args.lr, lr_schedule=args.lr_schedule,
                                 warmup_rounds=args.warmup_rounds, grad_clip=args.grad_clip,
                                 slowmo_beta=args.slowmo_beta, rounds=args.rounds, sched_start=sched_start)
    except configs.FlagError as e:
        return None, f"error: {e}"
    return bundle, None


def _check_flags(args) -> str | None:
    if args.eval_every > 0 and args.eval_batches <= 0:
        return "error: --eval-every requires --eval-batches"
    if args.slowmo_beta is not None and args.slowmo_beta >= 0.4:
        # a measured hazard of the reference's convergence study, not style
        print(f"warning: --slowmo-beta {args.slowmo_beta}: the reference's convergence study destabilized at "
              "beta 0.5 on a momentum-SGD workload (top-1 0.796 -> 0.121); start at 0.2 and raise only while "
              "held-out accuracy holds", file=sys.stderr)
    return None


def _layout(engine, gossiped, stacked: bool) -> str:
    plan = engine.bucket_plan(gossiped, stacked=stacked)
    return "per-leaf wire" if plan is None else f"{plan.num_buckets} buckets"


def _main_collective(args, world, sched_start) -> int:
    from consensusml_tpu_torch.comm.launch import RankFailed
    from consensusml_tpu_torch.device import resolve_device
    from consensusml_tpu_torch.train import collective

    dev = resolve_device(args.device)
    bundle, error = _bundle(args, dev, world, sched_start)
    if error is not None:
        print(error, file=sys.stderr)
        return 2
    engine = bundle.cfg.engine()
    _describe(bundle, engine, args.config)
    _describe_training(args, bundle)
    topo = engine.topology
    period = f", period {topo.period}" if topo.is_time_varying else ""
    print(f"{args.config}/{args.scale}: {bundle.world_size} ranks (collective, --dist-backend "
          f"{args.dist_backend}) on {args.device}, topology {topo.name}{period}", flush=True)
    spec = {**vars(args), "workers": bundle.world_size, "sched_start": sched_start}
    try:
        collective.run(spec, bundle.world_size)
    except RankFailed as e:
        if 3 in e.exit_codes.values():  # a rank's watchdog fired
            print(f"error: {e}", file=sys.stderr)
            return 3
        raise
    return 0


def main(argv=None) -> int:
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.device import resolve_device
    from consensusml_tpu_torch.train.evaluate import evaluate
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
    from consensusml_tpu_torch.train.run import due, eval_text, extras_text, start_watchdog, train_extras
    from consensusml_tpu_torch.utils.checkpoint import AsyncSaver, restore_state
    from consensusml_tpu_torch.utils.logging import MetricsLogger

    args = parse_args(argv)
    if args.backend == "simulated":
        dev = resolve_device(args.device)
    error = _check_flags(args)
    world, sched_start, resume_error = _resume_plan(args)
    error = error or resume_error
    if error is not None:
        print(error, file=sys.stderr)
        return 2
    if args.backend == "collective":
        return _main_collective(args, world, sched_start)
    bundle, error = _bundle(args, dev, world, sched_start)
    if error is not None:
        print(error, file=sys.stderr)
        return 2
    engine = bundle.cfg.engine()
    _describe(bundle, engine, args.config)
    _describe_training(args, bundle)
    params, model_state = configs.init_on_device(bundle, args.seed, dev)
    frozen = configs.frozen_on_device(bundle, dev)
    state = init_stacked_state(bundle.cfg, params, bundle.world_size, seed=args.seed, model_state=model_state,
                               frozen=frozen)
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    gossiped = {"params": state.params, "model_state": state.model_state}
    topo = engine.topology
    period = f", period {topo.period}" if topo.is_time_varying else ""
    shared = f" + {sum(t.numel() for t in frozen.values())} frozen, held once" if frozen else ""
    print(f"{args.config}/{args.scale}: {bundle.world_size} workers on {dev}, "
          f"{sum(p[0].numel() for p in params.values())} params per worker{shared}, "
          f"{_layout(engine, gossiped, True)}, topology {topo.name}{period}",
          flush=True)
    del gossiped, params, model_state
    if args.resume is not None:
        try:
            state = restore_state(args.resume, state)
        except (OSError, ValueError, RuntimeError) as e:
            print(f"error: cannot restore {args.resume}: {type(e).__name__}: {str(e)[:400]}", file=sys.stderr)
            return 2
        print(f"resumed from {args.resume} at round {state.step}", flush=True)
    start, end = state.step, state.step + args.rounds
    spec = vars(args)

    def run_eval(rnd):
        result = evaluate(bundle.eval_fn, state, bundle.eval_batches(args.eval_batches, args.seed))
        print(eval_text(result, rnd), flush=True)

    watchdog = start_watchdog(args.round_timeout)
    saver, last_saved = AsyncSaver(), None
    with MetricsLogger(args.metrics_out) as logger:
        for i, batch in enumerate(bundle.batches(args.rounds, args.seed, start=start)):
            rnd = start + i
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, err = float(m["loss"]), float(m["consensus_error"])
            ms = 1e3 * (time.perf_counter() - t0)
            if rnd % args.log_every == 0 or rnd == end - 1:
                extras = train_extras(spec, bundle.cfg.optimizer, state.opt_state)
                imgs = f" imgs/s {m['imgs_per_s']:.1f}" if "imgs_per_s" in m else ""
                alive = f" alive_frac {float(m['alive_frac']):.4g}" if "alive_frac" in m else ""
                print(f"round {rnd}: loss {loss:.4f} consensus_error {err:.6g} round_ms {ms:.1f}{imgs}{alive}"
                      f"{extras_text(extras)}", flush=True)
                logger.log(rnd, {"loss": loss, "consensus_error": err, "round_ms": ms, **extras,
                                 **{k: m[k] for k in ("alive_frac", "imgs_per_s") if k in m}})
            if watchdog is not None:
                watchdog.beat(f"round {rnd}")
            if due(args.eval_every, rnd) and rnd + 1 != end:
                if watchdog is not None:
                    watchdog.pause()  # an eval has no per-round budget
                run_eval(rnd)
                if watchdog is not None:
                    watchdog.beat(f"eval done @ round {rnd}")
            if args.checkpoint_dir and due(args.checkpoint_every, rnd):
                saver.submit(args.checkpoint_dir, state, step=rnd + 1)
                last_saved = rnd + 1
    if args.checkpoint_dir and last_saved != end:
        saver.submit(args.checkpoint_dir, state, step=end)
    if watchdog is not None:
        watchdog.stop()
    if args.checkpoint_dir:
        saver.wait()
        print(f"checkpoint: {saver.last_path}", flush=True)
    if args.eval_batches > 0:
        run_eval(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
