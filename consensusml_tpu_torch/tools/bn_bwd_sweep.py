"""Time the fused-BN backward kernel (``bn_bwd``) over launch plans at
ResNet-50's BN views, on one card.

    python consensusml_tpu_torch/tools/bn_bwd_sweep.py [--iters 30] [--views 131072x256,2048x2048]

For each (M, C) view (bf16, relu on, the values ``chip_smoke.py``'s BN
check draws): the default plan (``fused_bn.bn_bwd_plan``) is held against
the plain versions first (``dx`` equal to ``bn_bwd_dx_plain`` fed the
kernel's own sums times f32(1/M), the sums within ``BN_SUM_RTOL`` of
``bn_bwd_reduce_plain``'s and equal over three reruns); then every plan of
the sweep (clusters of 8 or 16 blocks, tile widths, on-chip or streaming
form) is checked the same way and timed by profiler device time over
back-to-back calls, beside ``F.batch_norm``'s autograd backward on the
same values. One JSON line a view: per plan its time, its time over the
3-pass byte bound and over the library call's, and how many of its
clusters the card holds at once. The last line names the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from consensusml_tpu_torch import kernels  # noqa: E402
from consensusml_tpu_torch.models import fused_bn as tbn  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BN_SUM_RTOL = 2e-6  # chip_smoke.py's
RESNET50_VIEWS = ((131072, 64), (131072, 128), (131072, 256), (32768, 128), (32768, 256), (32768, 512),
                  (8192, 256), (8192, 512), (8192, 1024), (2048, 512), (2048, 2048))


def device_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean device milliseconds a call of ``fn()`` (every kernel it
    launches, under ``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(
        getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e3 / iters


def max_active_clusters(plan) -> int:
    fn = tbn._bind("cml_bn_bwd_max_active_clusters", [ctypes.c_int] * 4)
    return fn(plan.cluster, plan.tile, plan.chunk, plan.nbuf)


def case(m: int, c: int, dev):
    gen = torch.Generator(device=dev).manual_seed(6)
    x = (2 * torch.randn(m, c, generator=gen, device=dev) + 0.3).to(torch.bfloat16)
    dy = torch.randn(m, c, generator=gen, device=dev).to(torch.bfloat16)
    gamma = 1 + 0.5 * torch.randn(c, generator=gen, device=dev)
    beta = 0.1 * torch.randn(c, generator=gen, device=dev)
    mean, var = tbn.batch_moments(*tbn.bn_stats_plain(x), m)
    scale, shift, rsqrt = tbn.fold_params(gamma, beta, mean, var, 1e-5)
    return x, dy, gamma, beta, (scale, shift, mean, rsqrt)


def check(x, dy, vecs, plan) -> dict:
    """The plan's outputs against the plain versions; raises on a miss."""
    m = x.shape[0]
    runs = [tbn.bn_bwd(dy, x, *vecs, True, plan=plan) for _ in range(3)]
    dx, db, dg = runs[0]
    dbp, dgp = tbn.bn_bwd_reduce_plain(dy, x, *vecs, True)
    inv = tbn.inv_rows(m)
    want = tbn.bn_bwd_dx_plain(dy, x, *vecs, db * inv, dg * inv, True)
    g = dy.float() * (x.float() * vecs[0] + vecs[1] > 0)
    xhat = (x.float() - vecs[2]) * vecs[3]
    err = max(float(((db - dbp).abs() / g.abs().sum(0).clamp_min(1e-30)).max()),
              float(((dg - dgp).abs() / (g * xhat).abs().sum(0).clamp_min(1e-30)).max()))
    same = all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))
    out = {"dx_equal": bool(torch.equal(dx, want)), "sum_rel_err": err, "reruns_equal": same}
    if not (out["dx_equal"] and err <= BN_SUM_RTOL and same):
        raise AssertionError(f"bn_bwd {plan} disagrees with its plain version: {out}")
    return out


def sweep_plans(m: int, c: int):
    """The default plan first, then every cluster size x tile width x form."""
    plans = [tbn.bn_bwd_plan(m, c, 2, 8)]
    for cluster in (8, 16):
        for tile in (8, 16, 32, 64, 128, 256):
            if tile > c or cluster * -(-c // tile) < 32:
                continue
            for onchip in (True, False):
                try:
                    p = tbn.bn_bwd_plan(m, c, 2, 8, cluster=cluster, tile=tile, onchip=onchip)
                except ValueError:
                    continue
                if p not in plans:
                    plans.append(p)
    return plans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--views", default=None, help="comma-separated MxC views (default: ResNet-50's eleven)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bn_bwd_sweep: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    views = RESNET50_VIEWS if args.views is None else tuple(
        tuple(int(v) for v in s.split("x")) for s in args.views.split(","))
    dev = torch.device("cuda", 0)
    kernels.build(["fused_bn"])
    for m, c in views:
        x, dy, gamma, beta, vecs = case(m, c, dev)
        side = int(round((m // 128) ** 0.5))
        x4 = x.view(128, side, side, c).permute(0, 3, 1, 2).detach().requires_grad_()
        dy4 = dy.view(128, side, side, c).permute(0, 3, 1, 2)
        g32, b32 = gamma.detach().requires_grad_(), beta.detach().requires_grad_()

        def lib_fwd():
            with torch.no_grad():
                F.batch_norm(x4, None, None, g32, b32, training=True)

        def lib_fwd_bwd():
            torch.autograd.grad(F.batch_norm(x4, None, None, g32, b32, training=True), (x4, g32, b32), dy4)

        lib = device_ms(lib_fwd_bwd, args.iters) - device_ms(lib_fwd, args.iters)
        bound = 1e3 * (3 * m * c * 2 + 6 * 4 * c) / HBM_BYTES_PER_S
        rows = []
        for i, plan in enumerate(sweep_plans(m, c)):
            ok = check(x, dy, vecs, plan)
            ms = device_ms(lambda: tbn.bn_bwd(dy, x, *vecs, True, plan=plan), args.iters)
            rows.append({"default": i == 0, **plan._asdict(), "blocks": plan.cluster * -(-c // plan.tile),
                         "max_active_clusters": max_active_clusters(plan), "ms": ms,
                         "x_bound": ms / bound, "x_library": ms / lib, **ok})
        print(json.dumps({"view": [m, c], "bound_ms": bound, "library_ms": lib, "plans": rows}), flush=True)
        del x, dy, x4, dy4
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
