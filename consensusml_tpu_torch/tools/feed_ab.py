"""Alternate the train CLI's ``--prefetch-depth 2`` and ``--prefetch-depth 0``
on ``cifar_resnet50`` full (ResNet-50, 8 workers) with ``--native-loader``
(the u8 wire) and ``--norm-impl pallas``, in one process on one card.

    python consensusml_tpu_torch/tools/feed_ab.py [--pairs 10] [--rounds 3] [--out FILE]

One unrecorded run at depth 0 builds the kernels and warms the allocator.
Then the runs go 2, 0, 0, 2, 2, 0, ... so drift in the host's speed falls
on both depths alike; cuDNN is held to its deterministic algorithms, as
``chip_smoke.py``'s ``train_resnet_feed`` holds it. Each run's round times
come from its metrics file. Round 0 (the ring's first fill, the first
launches) is kept apart from the later rounds. Prints one JSON line a run,
then a summary line: per depth the median of the later rounds' ms, each
pair's difference (depth 2 minus depth 0, each run's median), how many
pairs depth 2 won, and whether every run's losses and consensus errors
are equal. The last line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def run(depth: int, rounds: int, tmp: str) -> dict:
    from consensusml_tpu_torch.train.__main__ import main as train_main

    metrics = os.path.join(tmp, f"m-{depth}.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    argv = ["--config", "cifar_resnet50", "--scale", "full", "--norm-impl", "pallas", "--native-loader",
            "--rounds", str(rounds), "--seed", "0", "--prefetch-depth", str(depth), "--metrics-out", metrics]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_main(argv)
    if rc != 0:
        raise SystemExit(f"train {' '.join(argv)} exited {rc}: {out.getvalue()[-2000:]}")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    return {"depth": depth, "round_ms": [r["round_ms"] for r in rows],
            "curve": [(r["loss"], r["consensus_error"]) for r in rows]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--out", default=None, help="also write every run and the summary here as JSON")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("error: feed_ab needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    order = [(2, 0) if i % 2 == 0 else (0, 2) for i in range(args.pairs)]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        run(0, args.rounds, tmp)  # builds the kernels; not recorded
        for i, pair in enumerate(order):
            for depth in pair:
                r = dict(run(depth, args.rounds, tmp), pair=i)
                runs.append(r)
                print(json.dumps(r), flush=True)

    def later(r):
        return statistics.median(r["round_ms"][1:])

    by_depth = {d: [r for r in runs if r["depth"] == d] for d in (2, 0)}
    diffs = [later(next(r for r in runs if r["pair"] == i and r["depth"] == 2))
             - later(next(r for r in runs if r["pair"] == i and r["depth"] == 0)) for i in range(args.pairs)]
    summary = {
        "config": "cifar_resnet50 full --norm-impl pallas --native-loader (u8 wire), cuDNN deterministic",
        "rounds": args.rounds, "pairs": args.pairs, "order": "2,0 then 0,2, alternating",
        "median_later_round_ms": {f"depth_{d}": statistics.median(ms for r in rs for ms in r["round_ms"][1:])
                                  for d, rs in by_depth.items()},
        "median_round0_ms": {f"depth_{d}": statistics.median(r["round_ms"][0] for r in rs)
                             for d, rs in by_depth.items()},
        "pair_diff_ms": diffs, "median_pair_diff_ms": statistics.median(diffs),
        "depth2_faster_pairs": sum(d < 0 for d in diffs),
        "curves_equal": all(r["curve"] == runs[0]["curve"] for r in runs),
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": runs, "summary": summary}, f)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    return 0 if summary["curves_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
