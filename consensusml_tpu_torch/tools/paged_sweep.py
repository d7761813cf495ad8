"""Time the paged-attention kernel over launch plans, on one card.

    python consensusml_tpu_torch/tools/paged_sweep.py [--iters 50]
    python consensusml_tpu_torch/tools/paged_sweep.py --cpu [--iters 5]

Two cases at GPT-2-medium's serving shapes (8 slots, 16 heads, head dim
64, 16-token pages, 64 pages a slot; bf16), each at W = 1 (decode) and
W = 4 (a verify window):

- ``check``: ``chip_smoke.py``'s paged check, lengths 1, 17, 511, 1024,
  100, 300, 700 and 64;
- ``decode_step``: ``chip_smoke.py``'s profiled decode step, slot 0 at
  710 tokens and the seven other lanes at one.

Every plan (``paged_plan`` with 1, 2, 4, 8 or 16 blocks a slot, rings of
2 to 8 page buffers where they fit) is first held against the plain
version (``PAGED_ATOL``/``PAGED_RTOL`` of ``chip_smoke.py``) and then
timed by ``chip_smoke.py``'s ``queued_ms`` (CUDA events over
back-to-back calls queued behind a sleep kernel; the host's time per
call stays out), cycling four page sets
(~134 MB, above the 50 MB L2, as 24 layers of real pages are).
One JSON line a case and W: per plan its time, its time over the byte
bound (each attended K and V row read once) and how many of its clusters
the card holds at once; the default plan is marked. The last line names
the card.

``--cpu`` times the CPU serving tier instead (no card needed): the plain
version, whose dot products and softmax sum are f64 rounded once, against
the same recipe with f32 sums (the reference's precision), by wall clock
on the CPU, at the same cases; one JSON line a case and W.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import chip_smoke as cs  # noqa: E402
from consensusml_tpu_torch import kernels  # noqa: E402
from consensusml_tpu_torch.models import paged_attention as tpa  # noqa: E402
from consensusml_tpu_torch.models.attention import gather_paged_kv  # noqa: E402

S, H, D, BS, NB = 8, 16, 64, 16, 64
CASES = {
    "check": (1, 17, 511, 1024, 100, 300, 700, 64),
    "decode_step": (710, 1, 1, 1, 1, 1, 1, 1),
}


def plans(w: int):
    """The default plan first, then every blocks-a-slot x ring that fits."""
    out = [tpa.paged_plan(NB, BS, H, D, w, H)]
    for pages in (4, 8, 16, 32, 64):
        for ring in range(2, 9):
            try:
                p = tpa.paged_plan(NB, BS, H, D, w, H, pages=pages, ring=ring)
            except ValueError:
                continue
            if p not in out:
                out.append(p)
    return out


def _plain_f32_sums(q, k_pages, v_pages, block_table, positions):
    """``paged_attention_plain``'s recipe (bf16) with its dot products and
    softmax sum in f32, for the ``--cpu`` timing only."""
    s, w, h, d = q.shape
    kg, vg = gather_paged_kv(k_pages, v_pages, block_table)
    logits = torch.einsum("swhd,sthd->shwt", q.float(), kg.float()) * (1.0 / torch.sqrt(torch.tensor(float(d))))
    keep = torch.arange(kg.shape[1])[None, None, :] <= positions[:, :, None]
    logits = torch.where(keep[:, None], logits, -1e30)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16).float()
    return torch.einsum("shwt,sthd->swhd", probs, vg.float()).to(torch.bfloat16)


def cpu_main(iters: int) -> int:
    gen = torch.Generator().manual_seed(0)
    n = S * NB + 1
    k, v = (torch.randn(n, BS, H, D, generator=gen).to(torch.bfloat16) for _ in range(2))
    table = (torch.randperm(n - 1, generator=gen)[: S * NB] + 1).view(S, NB).to(torch.int32)

    def wall_ms(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters

    for name, lengths in CASES.items():
        for w in (1, 4):
            pos = torch.clamp(torch.tensor(lengths)[:, None] - w + torch.arange(w)[None, :], min=0).to(torch.int32)
            q = torch.randn(S, w, H, D, generator=gen).to(torch.bfloat16)
            f64_ms = wall_ms(lambda: tpa.paged_attention_plain(q, k, v, table, pos))
            f32_ms = wall_ms(lambda: _plain_f32_sums(q, k, v, table, pos))
            print(json.dumps({"case": name, "w": w, "cpu_threads": torch.get_num_threads(), "plain_f64_ms": f64_ms,
                              "f32_sums_ms": f32_ms, "f64_over_f32": f64_ms / f32_ms}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--cpu", action="store_true", help="time the CPU serving tier's plain version instead")
    args = ap.parse_args(argv)
    if args.cpu:
        return cpu_main(args.iters)
    if not torch.cuda.is_available():
        print("paged_sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kernels.build(["paged_attention"])
    lib = tpa._lib()
    gen = torch.Generator(device=dev).manual_seed(0)
    n = S * NB + 1
    sets = [tuple(torch.randn(n, BS, H, D, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(2))
            for _ in range(4)]
    table = (torch.randperm(n - 1, generator=gen, device=dev)[: S * NB] + 1).view(S, NB).to(torch.int32).contiguous()
    for name, lengths in CASES.items():
        lengths_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for w in (1, 4):
            pos = torch.clamp(lengths_t[:, None] - w + torch.arange(w, device=dev)[None, :], min=0)
            pos = pos.to(torch.int32).contiguous()
            q = torch.randn(S, w, H, D, generator=gen, device=dev, dtype=torch.bfloat16)
            want = tpa.paged_attention_plain(q, *sets[0], table, pos).float()
            bound = 1e3 * (2 * sum(lengths) * H * D * 2 + 2 * q.numel() * 2 + table.numel() * 4
                           + pos.numel() * 4) / cs.HBM_BYTES_PER_S
            rows = []
            for i, p in enumerate(plans(w)):
                got = tpa.paged_attention(q, *sets[0], table, pos, plan=p).float()
                ratio = float(((got - want).abs() / (cs.PAGED_ATOL + cs.PAGED_RTOL * want.abs())).max())
                if not ratio <= 1.0:
                    raise AssertionError(f"paged_attention {name} W={w} {p}: error {ratio} of the tolerance")
                ms, enqueue_ms = cs.queued_ms(
                    torch, lambda it: tpa.paged_attention(q, *sets[it % 4], table, pos, plan=p), args.iters)
                rows.append({"default": i == 0, **p._asdict(), "ms": ms, "enqueue_ms": enqueue_ms,
                             "x_bound": ms / bound,
                             "worst_err_over_tol": ratio,
                             "max_active_clusters": lib.cml_paged_attention_max_active_clusters(
                                 1 if w == 1 else 4, p.splits, p.smem, int(p.kv_heads < H))})
            print(json.dumps({"case": name, "lengths": lengths, "w": w, "bound_ms": bound, "plans": rows}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
