"""``python -m consensusml_tpu_torch.train``: consensus-SGD training of the
port, mirroring ``train.py``'s flags for the slice that is ported
(``gpt2_topk`` on the simulated backend, on its own codec or ``--codec
int8``)::

    python -m consensusml_tpu_torch.train --scale smoke --device cpu --rounds 3
    python -m consensusml_tpu_torch.train --scale full --workers 4 --codec-warmup 1
    python -m consensusml_tpu_torch.train --scale full --workers 4 --codec-warmup 1 --codec int8

Runs on the card unless ``--device cpu`` is given (no CPU fallback).
Prints the resolved codec path, then one line per logged round: loss,
consensus error and the round's wall time.
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m consensusml_tpu_torch.train", description=__doc__.split("\n")[0])
    p.add_argument("--config", default="gpt2_topk", choices=["gpt2_topk"])
    p.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    p.add_argument("--workers", type=int, default=None, help="world size (default: the config's)")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--codec", default=None, choices=["topk_int8", "int8"],
                   help="default: the config's own (topk_int8: chunked top-k + int8 on the two-step "
                        "bucketed wire); int8: PallasInt8Compressor on the fused one-pass wire")
    p.add_argument("--codec-warmup", type=int, default=None,
                   help="exact warm-up rounds (default: the config's)")
    p.add_argument("--gamma", type=float, default=None, help="CHOCO consensus step (default: the config's)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default="simulated", choices=["simulated"])
    return p.parse_args(argv)


def main(argv=None) -> int:
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.device import resolve_device
    from consensusml_tpu_torch.models.convert import gpt2_from_flax
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

    args = parse_args(argv)
    dev = resolve_device(args.device)
    bundle = configs.build(
        args.config, args.scale, world=args.workers, codec=args.codec, gamma=args.gamma,
        codec_warmup=args.codec_warmup, device=dev,
    )
    fused = bundle.cfg.engine().fused_wire_active
    wire = "fused one-pass bucketed wire" if fused else "two-step bucketed wire"
    print(f"codec: {bundle.codec_path}; {wire} "
          f"(fused_wire={bundle.cfg.gossip.fused_wire}, active={fused})", flush=True)
    params = {n: t.to(dev) for n, t in gpt2_from_flax(bundle.init_params(args.seed)).items()}
    state = init_stacked_state(bundle.cfg, params, bundle.world_size, seed=args.seed)
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    print(f"{args.config}/{args.scale}: {bundle.world_size} workers on {dev}, "
          f"{sum(p[0].numel() for p in params.values())} params per worker, "
          f"{len(state.gossip.xhat)} buckets", flush=True)
    for r, batch in enumerate(bundle.batches(args.rounds, args.seed)):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, err = float(m["loss"]), float(m["consensus_error"])
        ms = 1e3 * (time.perf_counter() - t0)
        if r % args.log_every == 0 or r == args.rounds - 1:
            print(f"round {r}: loss {loss:.4f} consensus_error {err:.6g} round_ms {ms:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
