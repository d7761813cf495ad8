"""Time the BN statistics kernel (``bn_stats``, one launch) over launch plans
at ResNet-50's BN views, and the LN backward kernel (``ln_bwd``, one
launch) over its ring depth and grid, on one card.

    python consensusml_tpu_torch/tools/norm_sweep.py [--iters 100] [--views 131072x256,2048x2048] [--no-ln]

BN, for each (M, C) view (bf16, the values ``chip_smoke.py``'s BN check
draws): every plan of the sweep (1, 2 or 4 clusters of 8 or 16 blocks a
channel tile, tile widths from 16-byte to 256-byte rows, TMA rings of 32
and 64 KB or 16-byte loads from device memory; the default plan,
``fused_bn.bn_stats_plan``, first) is checked against the plain
version first (the sums within ``BN_SUM_RTOL`` of ``bn_stats_plain``'s,
the five per-channel vectors bit-equal to ``batch_moments`` and
``fold_params`` fed the kernel's sums, three reruns bit-identical; a plan
that misses is reported and not timed), then timed by CUDA events over
calls queued behind a sleep kernel (``chip_smoke.queued_ms``), beside ``torch.var_mean(x, 0,
correction=0)`` on the same values. LN, at ``chip_smoke.py``'s two check
shapes ((8192, 1024) bf16 and (2048, 1024) f32): rings of 1 to 4 rows (as
many as fit) and grids of 1 and 2 blocks an SM, each checked against
``ln_bwd_plain`` at the LN gates and for bit-identical reruns, then timed
the same way, beside ``F.layer_norm``'s autograd backward. One JSON line a
view or shape: per plan its time and its time over the byte bound and
over the library call's. The last line names the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from consensusml_tpu_torch import kernels  # noqa: E402
from consensusml_tpu_torch.models import fused_bn as tbn  # noqa: E402
from consensusml_tpu_torch.models import fused_ln as tln  # noqa: E402

RESNET50_VIEWS = ((131072, 64), (131072, 128), (131072, 256), (32768, 128), (32768, 256), (32768, 512),
                  (8192, 256), (8192, 512), (8192, 1024), (2048, 512), (2048, 2048))


def stats_plans(m: int, c: int):
    """The default plan first, then every cluster size x tile width x ring."""
    plans = [tbn.bn_stats_plan(m, c, 2, 8)]
    for cluster in (8, 16):
        for splits in (1, 2, 4):
            for tile in (8, 16, 32, 64, 128):
                if tile > c:
                    continue
                for ring in (32 * 1024, 64 * 1024, None):
                    p = tbn.bn_stats_plan(m, c, 2, 8, cluster=cluster, splits=splits, tile=tile, ring=ring,
                                          staged=ring is not None)
                    if p not in plans:
                        plans.append(p)
    return plans


def check_stats(x, gamma, beta, plan) -> dict:
    """The plan's seven rows against the plain version; raises on a miss."""
    m = x.shape[0]
    runs = [tbn._stats_launch(x, gamma, beta, 1e-5, plan) for _ in range(3)]
    got = runs[0]
    sp, sqp = tbn.bn_stats_plain(x)
    xf = x.float()
    err = max(float(((got[0] - sp).abs() / xf.abs().sum(0).clamp_min(1e-30)).max()),
              float(((got[1] - sqp).abs() / (xf * xf).sum(0).clamp_min(1e-30)).max()))
    mean, var = tbn.batch_moments(got[0], got[1], m)
    want = (mean, var, *tbn.fold_params(gamma, beta, mean, var, 1e-5))
    vectors_equal = all(torch.equal(g, w) for g, w in zip(got[2:], want))
    same = all(torch.equal(r, got) for r in runs[1:])
    out = {"sum_rel_err": err, "vectors_equal": vectors_equal, "reruns_equal": same}
    if not (err <= cs.BN_SUM_RTOL and vectors_equal and same):
        raise AssertionError(f"bn_stats {plan} disagrees with its plain version: {out}")
    return out


def sweep_bn(views, iters: int, dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(6)
    for m, c in views:
        x, _dy, gamma, beta = cs.bn_case(torch, dev, gen, m, c)
        lib = cs.queued_ms(torch, lambda _: torch.var_mean(x, 0, correction=0), iters)[0]
        bound = cs.bound_ms(2 * m * c + 2 * 4 * c, 3 * m * c, cs.F32_FLOPS)[0]
        rows = []
        for i, plan in enumerate(stats_plans(m, c)):
            blocks = plan.cluster * plan.splits * -(-c // plan.tile)
            try:
                ok = check_stats(x, gamma, beta, plan)
            except AssertionError as err:  # a plan whose long per-thread sums miss the gate is reported, not timed
                rows.append({"default": i == 0, **plan._asdict(), "blocks": blocks, "failed": str(err)})
                continue
            ms = cs.queued_ms(torch, lambda _: tbn._stats_launch(x, gamma, beta, 1e-5, plan), iters)[0]
            rows.append({"default": i == 0, **plan._asdict(), "blocks": blocks, "ms": ms,
                         "x_bound": ms / bound, "x_library": ms / lib, **ok})
        print(json.dumps({"kernel": "bn_stats", "view": [m, c], "bound_ms": bound, "library_ms": lib,
                          "library": "torch.var_mean(x, 0, correction=0)", "plans": rows}), flush=True)
        del x
        torch.cuda.empty_cache()


def sweep_ln(iters: int, dev) -> None:
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(8)
    sms = tln._sms(dev)
    for m, h, dtype in ((8192, 1024, torch.bfloat16), (2048, 1024, torch.float32)):
        x, dy, gamma, beta = cs.ln_case(torch, dev, gen, m, h, dtype)
        eb = x.element_size()
        w, b = gamma.to(dtype), beta.to(dtype)
        xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))
        with torch.no_grad():
            fwd = cs.queued_ms(torch, lambda _: F.layer_norm(x, (h,), w, b, 1e-6), iters)[0]
        lib = cs.queued_ms(torch, lambda _: torch.autograd.grad(F.layer_norm(xr, (h,), wr, br, 1e-6), (xr, wr, br),
                                                                dy), iters)[0] - fwd
        bound = cs.bound_ms(3 * eb * m * h + 12 * h, 16 * m * h, cs.F32_FLOPS)[0]
        dxp, _dgp, _dbp = tln.ln_bwd_plain(dy, x, gamma, 1e-6)
        default = tln.ln_bwd_plan(m, h, eb, eb, sms)
        plans = [default]
        for per_sm in (1, 2):
            for slots in (1, 2, 3, 4):
                try:
                    p = tln.ln_bwd_plan(m, h, eb, eb, per_sm * sms, slots=slots)
                except ValueError:
                    continue
                if p not in plans:
                    plans.append(p)
        rows = []
        for i, plan in enumerate(plans):
            runs = [tln.ln_bwd(dy, x, gamma, 1e-6, plan=plan) for _ in range(3)]
            same = all(torch.equal(u, v) for r in runs[1:] for u, v in zip(r, runs[0]))
            dx_err = cs.ln_row_err(torch, runs[0][0], dxp)
            if not (same and dx_err <= 1):
                raise AssertionError(f"ln_bwd {plan}: reruns equal {same}, dx err over tolerance {dx_err}")
            ms = cs.queued_ms(torch, lambda _: tln.ln_bwd(dy, x, gamma, 1e-6, plan=plan), iters)[0]
            rows.append({"default": i == 0, **plan._asdict(), "ms": ms, "x_bound": ms / bound, "x_library": ms / lib,
                         "dx_err_over_tol": dx_err})
        print(json.dumps({"kernel": "ln_bwd", "shape": [m, h, str(dtype).split(".")[-1]], "bound_ms": bound,
                          "library_ms": lib, "library": "F.layer_norm autograd backward", "plans": rows}),
              flush=True)
        del x, dy, xr
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--views", default=None, help="comma-separated MxC BN views (default: ResNet-50's eleven)")
    ap.add_argument("--no-ln", action="store_true", help="sweep the BN statistics only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("norm_sweep: no CUDA device", file=sys.stderr)
        return 2
    views = RESNET50_VIEWS if args.views is None else tuple(
        tuple(int(v) for v in s.split("x")) for s in args.views.split(","))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels.build(["fused_bn", "fused_ln"])
    sweep_bn(views, args.iters, dev)
    if not args.no_ln:
        sweep_ln(args.iters, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
