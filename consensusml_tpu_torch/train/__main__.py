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
backend; with ``--workers W'`` at another world size it resizes the
state, ``utils/elastic.py``: survivors keep their rows, joiners start from
the consensus mean, the gossip state and SlowMo restart),
``--round-timeout S`` hard-exits with code 3 when a round makes no
progress for S seconds (``utils/watchdog.py``; armed after the first
round, paused during an eval), ``--data-dir`` trains on MNIST, CIFAR-10 or
token files (``data/files.py``), ``--metrics-out PATH`` appends one JSON
record a logged round (``utils/logging.py``) and ``--export-serving DIR``
writes the consensus mean as a serving artifact at the end and at every
``--checkpoint-every`` boundary (``serve/export.py``; each export bumps its
generation, which an engine watching ``DIR`` flips to).

The input pipeline (``train/feed.py``): every round's batch goes through
the overlapped device feed (``data/prefetch.py``; ``--prefetch-depth N``
batches staged ahead, 2 by default, 0 for none; the run ends with a
``feed:`` line); ``--native-loader`` makes the batches with the C++ ring
(``native/``, ``data/native_pipeline.py``), on the u8 wire for the image
configs unless ``--native-wire f32`` is given (the step dequants on the
device).

Telemetry (the reference's flags and families, ``train/telemetry.py``):
``--trace-events PATH`` writes the span ring as Chrome trace-event JSON at
exit, ``--metrics-prom PATH`` the registry as a Prometheus textfile every
``--telemetry-every`` rounds and at exit, ``--metrics-port PORT`` serves
``/metrics``, ``/traces``, ``/requests``, ``/alerts``, ``/query`` and
``/healthz`` live (0: a free port, printed), ``--flight-recorder DIR``
dumps the last rounds' spans and metric snapshots on a watchdog timeout,
an unhandled exception or SIGTERM, and ``--profile-dir DIR`` writes a
``torch.profiler`` trace of rounds 2-3 (``/profile?ms=N`` on the
endpoint captures the live loop on demand, 409 while that window is
open). ``--cost-ledger`` counts the run's executables at round 0 (the
``cost ledger:`` lines), samples the live memory gauges at telemetry
cadence and prints the ``cost attribution:`` and ``hbm reconciliation:``
lines at the end (``obs/costs.py``, ``obs/memviz.py``). The cluster plane: the
consensus-health monitor is always on, ``--link-probes`` times a small
transfer across every directed gossip edge at telemetry cadence, and
``--obs-cluster-dir DIR`` rewrites this rank's snapshot there (render the
directory with ``python -m consensusml_tpu_torch.tools.obs_report DIR``).

Live membership (``swarm/``, the simulated backend only): ``--churn-schedule
SPEC`` replays joins, drops, rejoins and stragglers
(``"join@1:2;drop@2:3;straggle@3:5x2;rejoin@4:3"``, or the generator form
``"seed=S,rounds=R,joins=J,drops=D,stragglers=K"``) while training: joiners
gossip-bootstrap from their neighbours (no checkpoint read), a dropped
worker's replica is frozen until it rejoins, and push-sum takes over
whenever the membership is asymmetric::

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
    python -m consensusml_tpu_torch.train --config gpt2_topk --device cpu --rounds 2 --export-serving ART
    python -m consensusml_tpu_torch.train --config mnist_mlp --device cpu --rounds 3 --telemetry-every 2 \
        --trace-events T.json --metrics-prom M.prom --metrics-port 0 --flight-recorder FR
    python -m consensusml_tpu_torch.train --config cifar_resnet50 --scale full --norm-impl pallas \
        --resume D/step_2 --workers 12 --link-probes --obs-cluster-dir OBS --telemetry-every 1
    python -m consensusml_tpu_torch.train --config mnist_mlp --device cpu --rounds 6 \
        --churn-schedule "join@1:2;drop@2:3;straggle@3:5x2;rejoin@4:3" --obs-cluster-dir OBS
    python -m consensusml_tpu_torch.tools.obs_report OBS
    python -m consensusml_tpu_torch.train --config cifar_resnet50 --scale full --norm-impl pallas --native-loader \
        [--prefetch-depth 0] [--native-wire f32]

Runs on the card unless ``--device cpu`` is given (no CPU fallback); before
its first CUDA call it probes the card in a child process
(``utils/gpu_health.py``; a probe that hangs or fails exits 2 with the
reason; ``CONSENSUSML_SKIP_GPU_PROBE=1`` skips it). The simulated backend
draws and uploads the initial parameters a worker at a time
(``configs.init_on_device``).
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
import contextlib
import sys
import time

import torch


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
    p.add_argument("--native-loader", action="store_true",
                   help="assemble round batches with the C++ prefetch ring (producer threads run ahead of the "
                        "device; see data/native_pipeline.py). Sample draws differ from the Python loaders' "
                        "numpy streams by design")
    p.add_argument("--native-wire", choices=("f32", "u8"), default=None,
                   help="host->device wire format for --native-loader image batches: u8 ships quantized bytes "
                        "(1/4 the transfer; file images re-ship their original bytes) and the step dequants on "
                        "the device. Default: u8 for image/classification configs, f32 otherwise (pass "
                        "--native-wire f32 to force the float wire)")
    p.add_argument("--prefetch-depth", type=int, default=2, metavar="N",
                   help="overlapped host->device feed: stage up to N round batches on the device ahead of the "
                        "consumer (DevicePrefetcher; 2 = double buffering, the copy for round r+1 overlaps round "
                        "r's compute). 0 disables the overlap (batches copy synchronously at dispatch); the "
                        "feed-stall time lands on the consensusml_feed_stall_seconds gauge whenever the "
                        "prefetcher runs")
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
    p.add_argument("--export-serving", default=None, metavar="DIR",
                   help="write the consensus-mean serving artifact here at the end of the run (and at every "
                        "--checkpoint-every boundary); each export bumps its generation, so an engine watching "
                        "DIR (Engine.watch) flips to every new mean mid-traffic")
    p.add_argument("--metrics-out", default=None, help="JSONL metrics path")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (CPU and CUDA activities) of rounds 2-3 to this directory")
    p.add_argument("--trace-events", default=None, metavar="PATH",
                   help="write the host span ring as Chrome trace-event JSON here at exit (Perfetto / "
                        "chrome://tracing loadable; spans are also torch.profiler ranges)")
    p.add_argument("--metrics-prom", default=None, metavar="PATH",
                   help="write the telemetry registry as a Prometheus textfile here (atomically, every "
                        "--telemetry-every rounds and at exit)")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve the live observability endpoints over HTTP on this port (0 = pick a free one): "
                        "/metrics (Prometheus text), /traces (merged Chrome trace), /requests, /alerts, /query, "
                        "/healthz")
    p.add_argument("--cost-ledger", action="store_true",
                   help="register the run's executables (train step, gossip round under its bucket plan) in the "
                        "cost ledger: one counting pass each (FakeTensorMode; kernels by their shapes) into the "
                        "consensusml_cost_*/consensusml_compile_* families, live memory gauges at --telemetry-every "
                        "cadence, and the three-way analytic/counted/live memory drift (costs ONE analysis pass per "
                        "executable at round 0: nothing launched, allocated or drawn)")
    p.add_argument("--telemetry-every", type=int, default=10, metavar="N",
                   help="cadence (rounds) for the heavier telemetry: metric snapshots, Prometheus rewrite, the "
                        "history-ring sample + SLO/alert rule evaluation, and the CHOCO ||s - xhat|| residual "
                        "fetch (default 10)")
    p.add_argument("--flight-recorder", default=None, metavar="DIR",
                   help="enable the crash flight recorder: on watchdog timeout, unhandled exception, or SIGTERM, "
                        "dump the last rounds' spans + metric snapshots to a timestamped JSON file in DIR")
    p.add_argument("--obs-cluster-dir", default=None, metavar="DIR",
                   help="cluster observability sideband: atomically rewrite this rank's obs-rank-N.json snapshot "
                        "(registry values, round progress, heartbeat) in DIR at --telemetry-every cadence; point "
                        "every rank of a swarm at one shared DIR and render the merged view with "
                        "python -m consensusml_tpu_torch.tools.obs_report")
    p.add_argument("--link-probes", action="store_true",
                   help="probe per-link latency/bandwidth: at --telemetry-every cadence, time one small transfer "
                        "across every directed gossip edge and export the consensusml_link_* families per "
                        "(src, dst) — the slowest-link ranking the cluster report consumes (host-side sideband, "
                        "never inside the round)")
    p.add_argument("--churn-schedule", default=None, metavar="SPEC",
                   help='live membership churn on the simulated backend: "join@R[:N];drop@R:U[,U..];'
                        'rejoin@R:U;straggle@R:UxD" or "seed=S,rounds=R,joins=J,drops=D,stragglers=K"; joiners '
                        "gossip-bootstrap from neighbors (no checkpoint read), dropped members freeze until rejoin")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--model-axes", default=None,
                   help='hybrid model parallelism for the collective backend: "tp=N" gives every worker N ranks '
                        "with params sharded per the config's TP rules (one axis only from the CLI); \"none\" "
                        "disables a config's default (full-scale llama_lora defaults to tp=4). Devices here are "
                        "the CUDA cards visible (the CPU counts as one): a config's default that needs more "
                        "than workers x N of them is dropped with a note, an explicit value is honoured, the "
                        "ranks sharing the cards (--dist-backend gloo)")
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


def _resume_plan(args) -> tuple[int | None, int, int | None, str | None]:
    """``(world, schedule start round, elastic_from, error)`` for
    ``--resume``: the run's world size (``--workers``, else the
    checkpoint's), the checkpoint's round, and the checkpoint's world size
    when an explicit ``--workers`` differs from it (an elastic resume),
    else None."""
    from consensusml_tpu_torch.utils.checkpoint import checkpoint_round, checkpoint_world_size

    if args.resume is None:
        return args.workers, 0, None, None
    world = checkpoint_world_size(args.resume)
    if world is None:
        return None, 0, None, (f"error: cannot restore {args.resume}: no cml_meta.json "
                               "(not a checkpoint of this trainer)")
    elastic_from = world if args.workers is not None and args.workers != world else None
    return args.workers or world, checkpoint_round(args.resume) or 0, elastic_from, None


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


def _describe_feed(args, bundle) -> None:
    """The reference's ``native wire:`` line (with ``--native-loader``);
    binds the resolved wire to the bundle."""
    from consensusml_tpu_torch.train import feed

    wire, why = feed.apply_native_wire(bundle, args.native_loader, args.native_wire)
    if args.native_loader:
        print(f"native wire: {wire} ({why})", flush=True)


def _layout(engine, gossiped, stacked: bool) -> str:
    plan = engine.bucket_plan(gossiped, stacked=stacked)
    return "per-leaf wire" if plan is None else f"{plan.num_buckets} buckets"


# what saves, restores, evaluates, exports or probes a worker's state, or
# needs its whole gradient or the in-flight group: not under model axes yet
_MODEL_AXES_REFUSED = (
    ("--resume", lambda a: a.resume is not None),
    ("--checkpoint-dir", lambda a: a.checkpoint_dir is not None),
    ("--export-serving", lambda a: a.export_serving is not None),
    ("--eval-batches", lambda a: a.eval_batches > 0),
    ("--drop-prob", lambda a: a.drop_prob > 0),
    ("--push-sum", lambda a: a.push_sum),
    ("--overlap-gossip", lambda a: a.overlap_gossip),
    ("--grad-clip", lambda a: a.grad_clip > 0),
    ("--cost-ledger", lambda a: a.cost_ledger),
    ("--link-probes", lambda a: a.link_probes),
    ("--obs-cluster-dir", lambda a: a.obs_cluster_dir is not None),
)


def _devices(args) -> int:
    """What ``--model-axes`` counts as devices: the CUDA cards visible, or
    one for ``--device cpu``."""
    return torch.cuda.device_count() if args.device == "cuda" else 1


def _model_axes(args, bundle) -> tuple[tuple, str | None]:
    """``(model_axes, error)``: the config's default (``bundle.model_axes``)
    or ``--model-axes``, parsed, refused and noted as the reference's
    ``train.py:682-760`` does (its ``note:`` line printed here)."""
    model_axes = bundle.model_axes
    user_set_axes = args.model_axes is not None
    if user_set_axes:
        if args.model_axes.strip().lower() in ("none", ""):
            model_axes = ()
        else:
            try:
                model_axes = tuple((kv.split("=")[0].strip(), int(kv.split("=")[1]))
                                   for kv in args.model_axes.split(","))
            except (IndexError, ValueError):
                return (), f'error: bad --model-axes {args.model_axes!r} (expected e.g. "tp=2" or "none")'
            if any(s < 1 for _, s in model_axes):
                return (), f"error: bad --model-axes {args.model_axes!r} (axis sizes must be >= 1)"
            if len(model_axes) > 1:
                # a config's tp_rules shard over ONE axis; silently
                # replicating over the extra axes would burn devices
                return (), ('error: --model-axes supports a single axis from the CLI (got "' + args.model_axes
                            + '"); multi-axis hybrid runs need a config with explicit rules (see '
                            "WorkerMesh.create + parallel.sharding)")
    if model_axes and bundle.tp_rules is None:
        return (), f"error: config {bundle.name} has no model-sharding rules; --model-axes is not supported for it"
    per_worker = 1
    for _, s in model_axes:
        per_worker *= s
    if model_axes and not user_set_axes and _devices(args) < bundle.world_size * per_worker:
        # the config's DEFAULT layout doesn't fit this host: drop it and
        # continue rather than failing on a flag the user never passed
        axes_str = ",".join(f"{n}={s}" for n, s in model_axes)
        print(f"note: dropping config default model_axes={axes_str} (needs {bundle.world_size}x{per_worker} "
              f"devices, have {_devices(args)}); pass --model-axes to force", flush=True)
        model_axes, per_worker = (), 1
    if args.backend == "simulated" and model_axes:
        return (), (f"error: --model-axes needs the collective backend ({bundle.world_size}x{per_worker} "
                    "devices)")
    bad = [flag for flag, on in _MODEL_AXES_REFUSED if on(args)] if model_axes else []
    if bad:
        return (), f"error: --model-axes does not run with {', '.join(bad)} yet"
    return model_axes, None


def _main_collective(args, world, sched_start, elastic_from) -> int:
    from consensusml_tpu_torch.comm.launch import RankFailed
    from consensusml_tpu_torch.device import resolve_device
    from consensusml_tpu_torch.train import collective, feed

    dev = resolve_device(args.device)
    bundle, error = _bundle(args, dev, world, sched_start)
    if error is not None:
        print(error, file=sys.stderr)
        return 2
    model_axes, error = _model_axes(args, bundle)
    error = error or feed.feed_error(bundle, args.native_loader, args.native_wire)
    if error is not None:
        print(error, file=sys.stderr)
        return 2
    engine = bundle.cfg.engine()
    _describe(bundle, engine, args.config)
    _describe_training(args, bundle)
    _describe_feed(args, bundle)
    topo = engine.topology
    period = f", period {topo.period}" if topo.is_time_varying else ""
    per = 1
    for _, size in model_axes:
        per *= size
    axes = "".join(f", model axes {n}={size} ({bundle.world_size * per} ranks)" for n, size in model_axes)
    print(f"{args.config}/{args.scale}: {bundle.world_size} ranks (collective, --dist-backend "
          f"{args.dist_backend}) on {args.device}, topology {topo.name}{period}{axes}", flush=True)
    spec = {**vars(args), "workers": bundle.world_size, "sched_start": sched_start, "elastic_from": elastic_from,
            "model_axes": [list(a) for a in model_axes]}
    try:
        collective.run(spec, bundle.world_size)
    except RankFailed as e:
        if 3 in e.exit_codes.values():  # a rank's watchdog fired
            print(f"error: {e}", file=sys.stderr)
            return 3
        raise
    return 0


_CHURN_REFUSED = (
    ("--backend collective", lambda a: a.backend == "collective"),
    ("--model-axes", lambda a: a.model_axes is not None),
    ("--native-loader", lambda a: a.native_loader),
    ("--resume", lambda a: a.resume is not None),
    ("--drop-prob", lambda a: a.drop_prob > 0),
    ("--overlap-gossip", lambda a: a.overlap_gossip),
    ("--checkpoint-every", lambda a: a.checkpoint_every > 0),
    ("--eval-every", lambda a: a.eval_every > 0),
    ("--profile-dir", lambda a: a.profile_dir is not None),
    ("--link-probes", lambda a: a.link_probes),
    ("--flight-recorder", lambda a: a.flight_recorder is not None),
    ("--round-timeout", lambda a: a.round_timeout > 0),
)


def _churn_refusal(args) -> str | None:
    """The reference's refusal of what ``--churn-schedule`` does not
    compose with (exit code 2)."""
    bad = [flag for flag, on in _CHURN_REFUSED if on(args)]
    if not bad:
        return None
    return (f"error: --churn-schedule runs the simulated swarm loop and does not compose with {', '.join(bad)} "
            "(scheduled churn IS the fault model; end-of-run --checkpoint-dir / --eval-batches still work)")


def _churn_loop(args, bundle, dev) -> int:
    """The ``--churn-schedule`` path (the reference's ``_churn_loop``): live
    membership churn on the simulated backend (``swarm/``). Joiners
    gossip-bootstrap from neighbours — no checkpoint read — drops freeze
    the member's replica until rejoin, and training never stops."""
    import os

    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.obs import ClusterWriter, get_registry, get_tracer
    from consensusml_tpu_torch.swarm import ChurnSchedule, alive_consensus_state, churn_config, run_churn
    from consensusml_tpu_torch.swarm import validate_schedule
    from consensusml_tpu_torch.train.evaluate import evaluate
    from consensusml_tpu_torch.train.run import eval_text
    from consensusml_tpu_torch.utils.checkpoint import save_state
    from consensusml_tpu_torch.utils.logging import MetricsLogger

    registry = get_registry()
    initial = bundle.world_size
    try:
        schedule = ChurnSchedule.parse(args.churn_schedule, initial_world=initial)
        cfg = churn_config(bundle.cfg)
        # dry-replay the whole schedule up front: a semantically invalid
        # sequence must be a clean exit 2 here, not a traceback mid-run
        validate_schedule(schedule, cfg.gossip.topology, args.rounds)
    except (ValueError, NotImplementedError) as e:
        print(f"error: --churn-schedule: {e}", file=sys.stderr)
        return 2
    capacity = initial + schedule.total_joins
    counts = schedule.counts()
    print(f"churn schedule: {schedule.spec()}", flush=True)
    print(f"swarm: initial={initial} capacity={capacity} joins={counts['join']} drops={counts['drop']} "
          f"rejoins={counts['rejoin']} stragglers={counts['straggle']} push_sum={cfg.gossip.push_sum!r}", flush=True)
    # batches come stacked at CAPACITY; the harness slices to the live
    # world each round, so slot i's stream is churn-independent
    cap_bundle = bundle if capacity == initial else configs.build(
        args.config, args.scale, world=capacity, codec=args.codec, gamma=args.gamma,
        codec_warmup=args.codec_warmup, norm_impl=args.norm_impl, device=dev, data_dir=args.data_dir)
    tracer = get_tracer()
    was_enabled = tracer.enabled
    if args.trace_events or args.metrics_prom or args.obs_cluster_dir:
        tracer.enabled = True
    history = alerts = None
    if (args.trace_events or args.metrics_prom or args.obs_cluster_dir or args.metrics_port is not None
            or args.cost_ledger):
        from consensusml_tpu_torch.obs import get_alert_engine, get_history

        history, alerts = get_history(), get_alert_engine()
    cluster = None
    if args.obs_cluster_dir:
        cluster = ClusterWriter(args.obs_cluster_dir, rank=0, registry=registry, world_size=capacity,
                                history=history, alerts=alerts)
        print(f"cluster snapshots: {cluster.path}", flush=True)
    init = configs.init_on_device(bundle, args.seed, dev)
    every = max(1, args.telemetry_every)

    with contextlib.ExitStack() as stack:
        logger = stack.enter_context(MetricsLogger(args.metrics_out))
        stack.callback(setattr, tracer, "enabled", was_enabled)

        def on_round(rnd, row):
            if rnd % max(1, args.log_every) == 0:
                logger.log(rnd, row)
            registry.counter("consensusml_rounds_total", "completed training rounds").inc()
            registry.gauge("consensusml_round_progress").set(rnd)
            registry.gauge("consensusml_heartbeat_time_seconds").set(time.time())
            if rnd % max(1, args.log_every) == 0:
                print(f"[round {rnd}] loss={row['loss']:.4f} consensus_error={row['consensus_error']:.4f} "
                      f"epoch={row['epoch']} active={row['active']}/{row['world']}", flush=True)
            if (rnd + 1) % every == 0:
                registry.snapshot({"round": rnd})
                if history is not None:
                    history.record()
                    alerts.evaluate()
                if args.metrics_prom:
                    registry.write_prometheus(args.metrics_prom)
                if cluster is not None:
                    cluster.write(round=rnd)

        def on_event(row):
            workers = ",".join(str(u) for u in row["workers"])
            detail = row.get("detail") or {}
            extra = (f" (bootstrap {detail['bootstrap_rounds']} rounds, eps {detail['eps_measured']:.2e})"
                     if "bootstrap_rounds" in detail
                     else (f" ({detail['duration']} rounds)" if "duration" in detail else ""))
            print(f"[round {row['round']}] membership {row['kind']}: w{workers}{extra}", flush=True)
            if cluster is not None:
                cluster.record_event(row)

        report = run_churn(cfg, bundle.loss_fn, init, schedule, rounds=args.rounds,
                           batches=lambda rounds, seed: cap_bundle.batches(rounds, seed), seed=args.seed,
                           registry=registry, on_round=on_round, on_event=on_event)
        del init
        if args.metrics_prom:
            registry.write_prometheus(args.metrics_prom)
        if cluster is not None:
            cluster.write(round=args.rounds - 1)
        if args.trace_events:
            print(f"trace events: {tracer.write_chrome_trace(args.trace_events)}", flush=True)

    view = report.final_view
    print(f"swarm final: epoch={view.epoch} members={view.n_active} active / {view.world_size} slots, "
          f"{len(report.bootstraps)} gossip bootstraps (no checkpoint reads), {report.recompiles} step rebuilds",
          flush=True)
    print(f"final: loss={report.losses[-1]:.4f} consensus_error={report.consensus_errors[-1]:.4f}", flush=True)
    if args.checkpoint_dir:
        path = save_state(os.path.join(args.checkpoint_dir, f"step_{args.rounds}"), report.final_state)
        print(f"checkpoint: {path}", flush=True)
    if args.eval_batches > 0:
        # members still DOWN at the end hold frozen stale replicas; the
        # mean model aggregates the LIVE swarm only
        result = evaluate(cap_bundle.eval_fn, alive_consensus_state(report.final_state, view),
                          cap_bundle.eval_batches(args.eval_batches, args.seed))
        print(eval_text(result, None), flush=True)
    return 0


def main(argv=None) -> int:
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.device import resolve_device
    from consensusml_tpu_torch.serve.export import export_serving, serving_meta
    from consensusml_tpu_torch.train.evaluate import evaluate
    from consensusml_tpu_torch.train.feed import feed_error, feed_text, round_feed
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
    from consensusml_tpu_torch.train.run import due, eval_text, extras_text, start_watchdog, train_extras
    from consensusml_tpu_torch.train.telemetry import Telemetry
    from consensusml_tpu_torch.utils import tree as T
    from consensusml_tpu_torch.utils.checkpoint import AsyncSaver, restore_state
    from consensusml_tpu_torch.utils.logging import MetricsLogger

    args = parse_args(argv)
    if args.device == "cuda":
        from consensusml_tpu_torch.utils.gpu_health import preflight

        # a wedged card hangs the first CUDA call: probe it in a child first
        probe_error = preflight()
        if probe_error is not None:
            print(probe_error, file=sys.stderr)
            return 2
    if args.backend == "simulated":
        dev = resolve_device(args.device)
    error = _check_flags(args)
    world, sched_start, elastic_from, resume_error = _resume_plan(args)
    error = error or resume_error
    if args.churn_schedule is not None:
        error = error or _churn_refusal(args)
    if error is not None:
        print(error, file=sys.stderr)
        return 2
    if args.backend == "collective":
        return _main_collective(args, world, sched_start, elastic_from)
    bundle, error = _bundle(args, dev, world, sched_start)
    if error is None and args.churn_schedule is None:
        error = _model_axes(args, bundle)[1]
    if error is not None:
        print(error, file=sys.stderr)
        return 2
    if args.churn_schedule is not None:
        return _churn_loop(args, bundle, dev)
    error = feed_error(bundle, args.native_loader, args.native_wire)
    if error is not None:
        print(error, file=sys.stderr)
        return 2
    engine = bundle.cfg.engine()
    _describe(bundle, engine, args.config)
    _describe_training(args, bundle)
    _describe_feed(args, bundle)
    params, model_state = configs.init_on_device(bundle, args.seed, dev)
    frozen = configs.frozen_on_device(bundle, dev)
    if elastic_from is None:
        state = init_stacked_state(bundle.cfg, params, bundle.world_size, seed=args.seed, model_state=model_state,
                                   frozen=frozen)
    else:
        # the checkpoint's world as the template (its values are overwritten by the restore)
        rows = lambda t: torch.empty((elastic_from, *t.shape[1:]), dtype=t.dtype, device=t.device)  # noqa: E731
        state = init_stacked_state(bundle.cfg, {n: rows(p) for n, p in params.items()}, elastic_from,
                                   seed=args.seed, model_state=T.tree_map(rows, model_state), frozen=frozen)
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
        if elastic_from is not None:
            from consensusml_tpu_torch.utils.elastic import resize_state

            state = resize_state(bundle.cfg, state, bundle.world_size, seed=args.seed)
            print(f"elastic resume: {elastic_from} -> {bundle.world_size} workers "
                  "(joiners from consensus mean; gossip state reset)", flush=True)
        print(f"resumed from {args.resume} at round {state.step}", flush=True)
    start, end = state.step, state.step + args.rounds
    spec = vars(args)

    def run_eval(rnd):
        result = evaluate(bundle.eval_fn, state, bundle.eval_batches(args.eval_batches, args.seed))
        print(eval_text(result, rnd), flush=True)

    per_worker = T.tree_map(lambda t: torch.empty(t.shape[1:], dtype=t.dtype, device="meta"),
                            {"params": state.params, "model_state": state.model_state})
    tel = Telemetry(spec, engine, per_worker, bundle.cfg.h, device=dev, world_size=bundle.world_size)
    watchdog = start_watchdog(args.round_timeout, tel.on_timeout if tel.recorder is not None else None)
    saver, last_saved = AsyncSaver(), None
    last_exported = None

    def export_art(rnd):
        # synchronous: the handoff is complete when its line prints
        nonlocal last_exported
        path = export_serving(args.export_serving, state, config_name=bundle.name, scale=args.scale, round=rnd)
        last_exported = rnd
        print(f"serving artifact: {path} (round {rnd}, generation {serving_meta(path)['generation']})", flush=True)

    feed = round_feed(bundle, spec, args.rounds, start, dev)
    with tel, MetricsLogger(args.metrics_out) as logger, contextlib.closing(feed):
        for i, batch in enumerate(feed):
            rnd = start + i
            if i == 0:
                tel.register_costs(step, state, batch, engine=engine)
            with tel.round(i, rnd):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                # the round's fetch, its fence (the fault mask only on fault runs)
                loss, err, alive_frac, mask = tel.fetch(lambda: (
                    float(m["loss"]), float(m["consensus_error"]),
                    float(m["alive_frac"]) if "alive_frac" in m else None,
                    m["alive_mask"].tolist() if "alive_mask" in m else None))
            ms = 1e3 * (time.perf_counter() - t0)
            if rnd % args.log_every == 0 or rnd == end - 1:
                extras = train_extras(spec, bundle.cfg.optimizer, state.opt_state)
                imgs = f" imgs/s {m['imgs_per_s']:.1f}" if "imgs_per_s" in m else ""
                alive = f" alive_frac {alive_frac:.4g}" if alive_frac is not None else ""
                print(f"round {rnd}: loss {loss:.4f} consensus_error {err:.6g} round_ms {ms:.1f}{imgs}{alive}"
                      f"{extras_text(extras)}", flush=True)
                logger.log(rnd, {"loss": loss, "consensus_error": err, "round_ms": ms, **extras,
                                 **({"alive_frac": alive_frac} if alive_frac is not None else {}),
                                 **({"imgs_per_s": m["imgs_per_s"]} if "imgs_per_s" in m else {})})
            if "gossip_ms" in m:
                tel.observe_cost("gossip.round", m["gossip_ms"] / 1e3)
            tel.after_round(rnd, err, alive_frac, mask, state, feed_s=getattr(feed, "last_stall_s", 0.0))
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
            if args.export_serving and due(args.checkpoint_every, rnd):
                export_art(rnd + 1)  # the serving handoff rides the checkpoint cadence
        tel.finish(end, state)
    line = feed_text(feed)
    if line is not None:
        print(line, flush=True)
    if args.checkpoint_dir and last_saved != end:
        saver.submit(args.checkpoint_dir, state, step=end)
    if watchdog is not None:
        watchdog.stop()
    if args.checkpoint_dir:
        saver.wait()
        print(f"checkpoint: {saver.last_path}", flush=True)
    if args.export_serving and last_exported != end:
        export_art(end)
    if args.eval_batches > 0:
        run_eval(None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
