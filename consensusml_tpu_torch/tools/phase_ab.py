"""Run ``chip_smoke.py``'s serve, GPT-2 ``train`` and ``train_topk`` and
ResNet-50 phases for two checkouts of this repository, in turns, on one
card.

    python consensusml_tpu_torch/tools/phase_ab.py PARENT_DIR CHANGE_DIR [--phases serve,train,train_topk,resnet,kernels]

Each run is a fresh process that imports its checkout's ``chip_smoke.py``
and so builds and loads that checkout's kernels. The order, parent,
change, change, parent, spreads drift in the host's speed over both
checkouts. A run prints one JSON line with the phases asked for: the
serving TTFT and decode rate and the profiled decode step (its wall,
device time, busy share and top kernels); the ``train`` line's round times
(gpt2_topk full, 4 workers, fused int8 wire) and the ``train_topk`` line's
(the config's top-k 8 of 512 + int8 on the two-step wire), each profiled
round's device time, busy share and each port kernel's device time by
CUDA symbol; the
``train_resnet`` (fused BN) and ``train_resnet_flax`` (PyTorch's batch
norm) lines' round times, profiled device time and busy share, the BN
kernels' device time (forward and backward apart where the checkout
reports them) and the host's time per BN backward call. The ``kernels``
phase times single kernels at ``chip_smoke.py``'s check shapes through
the wrappers both checkouts have: the LN forward and backward, the BN
statistics (``bn_forward_stats``) at the five BN check views, the flash
forward, dq and dk/dv at B=8 and B=1, S=1024, H=16, and paged attention at W=1 and 4;
each CUDA events over calls queued behind a sleep kernel
(``queued_ms``) and profiler device time by CUDA kernel name, so a
wrapper's launches show apart. The last line is the JSON list of all
runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from consensusml_tpu_torch import configs, kernels

phases = sys.argv[2].split(",")
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.build()
out = {"checkout": sys.argv[1]}
if "serve" in phases:
    serve, _ = cs.serve_phase(torch, dev)
    out["serve"] = {k: serve[k] for k in ("ttft_p50_ms", "intertoken_p50_ms", "decode_tokens_per_sec",
                                          "decode_step_profile")}
    torch.cuda.empty_cache()
gpt2 = [(p, codec) for p, codec in (("train", "int8"), ("train_topk", None)) if p in phases]
if gpt2:
    init = configs.build("gpt2_topk", "full", world=4, device=dev).init_params(0)
    for path, codec in gpt2:
        line, counts, _, _ = cs.train_phase(torch, dev, init, codec)
        prof = line["profiled_round"]
        out[path] = {
            "round_ms": [r["round_ms"] for r in line["rounds"]],
            "gossip_ms": [r["gossip_ms"] for r in line["rounds"]],
            "profiled_wall_ms": prof["wall_ms"], "device_kernel_ms": prof["device_kernel_ms"],
            "device_busy_share_of_unprofiled_round": prof.get("device_busy_share_of_unprofiled_round"),
            "port_kernels": prof["port_kernels"], "launches": {k: v for k, v in counts.items() if v},
        }
        torch.cuda.empty_cache()
    del init
    torch.cuda.empty_cache()
if "resnet" in phases:
    init = configs.build("cifar_resnet50", "full", device=dev).init_params(0)
    for path, norm_impl, counted in (("train_resnet", "pallas", 3), ("train_resnet_flax", "flax", 2)):
        line, counts = cs.train_resnet_phase(torch, dev, cs.resnet_init_named(init, norm_impl), norm_impl, counted)
        prof = line["profiled_round"]
        out[path] = {
            "round_ms": [r["round_ms"] for r in line["rounds"]],
            "profiled_wall_ms": prof["wall_ms"], "device_kernel_ms": prof["device_kernel_ms"],
            "device_busy_share_of_unprofiled_round": prof.get("device_busy_share_of_unprofiled_round"),
            "kernels_in_profiled_round": prof["kernels"],
            "bn_device_ms": line["bn_device_ms_in_profiled_round"],
            "bn_device_ms_by_pass": line.get("bn_device_ms_in_profiled_round_by_pass"),
            "bn_backward_host": line.get("bn_backward_host"),
            "port_kernels": prof["port_kernels"], "launches": {k: v for k, v in counts.items() if v},
        }
if "kernels" in phases:
    from torch.profiler import ProfilerActivity, profile
    from consensusml_tpu_torch.models import flash_attention as tfa
    from consensusml_tpu_torch.models import fused_bn as tbn
    from consensusml_tpu_torch.models import fused_ln as tln
    from consensusml_tpu_torch.models import paged_attention as tpa

    def split_ms(fn, iters=50):
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
        return {e.key: (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0))
                / 1e3 / iters for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}

    def timed(fn):
        return {"queued_ms": cs.queued_ms(torch, fn, 100)[0], "profiler_ms_by_kernel": split_ms(fn)}

    ker = {}
    gen = torch.Generator(device=dev).manual_seed(8)
    for m, h, dt in ((8192, 1024, torch.bfloat16), (2048, 1024, torch.float32)):
        x, dy, gamma, beta = cs.ln_case(torch, dev, gen, m, h, dt)
        name = f"({m}, {h}) {str(dt).split('.')[-1]}"
        ker[f"ln_fwd {name}"] = timed(lambda _: tln.ln_fwd(x, gamma, beta, 1e-6, dt))
        ker[f"ln_bwd {name}"] = timed(lambda _: tln.ln_bwd(dy, x, gamma, 1e-6))
    for m, c in cs.BN_CHECK_VIEWS:
        x, dy, gamma, beta = cs.bn_case(torch, dev, gen, m, c)
        ker[f"bn_stats ({m}, {c})"] = timed(lambda _: tbn.bn_forward_stats(x, gamma, beta, 1e-5))
    del x, dy
    for b in (8, 1):
        q, k, v, do = (torch.randn(b, 1024, 16, 64, generator=gen, device=dev, dtype=torch.bfloat16)
                       for _ in range(4))
        o, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        ker[f"flash_fwd B={b} S=1024"] = timed(lambda _: tfa.flash_attention(q, k, v, causal=True, return_lse=True))
        ker[f"flash_dq B={b} S=1024"] = timed(
            lambda _: tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True))
        ker[f"flash_dkv B={b} S=1024"] = timed(
            lambda _: tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True))
        del q, k, v, do, o
    torch.cuda.empty_cache()
    ker["paged_attention"] = {f"W={w}": r["ms"] for w, r in cs.check_paged(torch, tpa, dev).items()}
    out["kernels"] = ker
print(json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="root of the parent checkout")
    ap.add_argument("change", help="root of the changed checkout")
    ap.add_argument("--phases", default="serve,train,train_topk,resnet",
                    help="comma-separated phases to run: serve, train, train_topk, resnet, kernels "
                         "(default: the first four)")
    args = ap.parse_args(argv)
    unknown = set(args.phases.split(",")) - {"serve", "train", "train_topk", "resnet", "kernels"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    runs = []
    for root in (args.parent, args.change, args.change, args.parent):
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", CHILD, root, args.phases], capture_output=True, text=True,
                              cwd=root)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
