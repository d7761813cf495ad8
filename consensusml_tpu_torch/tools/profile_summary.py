"""Summarize a ``torch.profiler`` Chrome trace: the port's counterpart of
the reference's ``tools/xprof_summary.py``.

``--profile-dir`` (the train CLI's window) and the live ``/profile``
endpoint write ``torch.profiler`` Chrome traces; this prints the device
time by kernel directly:

    python -m consensusml_tpu_torch.train --config cifar_resnet50 --scale full --profile-dir /tmp/prof
    python consensusml_tpu_torch/tools/profile_summary.py /tmp/prof

Device events are the trace's CUDA kernels, copies and memsets
(``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``). A kernel keeps its
own name: the port's hand-written kernels (``flash_fwd_kernel``,
``paged_attention_kernel``, ``fused_choco_encode_kernel``, ...) are
C symbols, so each is its own row beside cuBLAS's and PyTorch's. As in
the reference, a trailing ``.N`` is merged into its bare name only when
the bare name is in the trace too. The host side: the CPU ops (``cat``
``cpu_op``) grouped by name, and with ``--host-trace`` the obs span
tracer's spans (``--trace-events``).

``--json`` emits the whole report as one JSON document (what the
``/profile`` endpoint returns as its ``summary``).
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
from collections import Counter, defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_json(root: str) -> str | None:
    """The newest Chrome trace under ``root`` (``*.json`` or ``*.json.gz``)."""
    hits = [p for pat in ("*.json", "*.json.gz") for p in glob.glob(os.path.join(root, "**", pat), recursive=True)]
    return max(hits, key=os.path.getmtime) if hits else None


def op_family(name: str, raw_names: set[str]) -> str:
    """The reference's rule: strip a trailing ``.N`` only when the bare name
    is in the trace too."""
    m = re.match(r"^(.*)\.(\d+)$", name)
    if m and m.group(1) in raw_names:
        return m.group(1)
    return name


def _load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _table(raw: Counter, top: int) -> tuple[float, list[dict]]:
    names = set(raw)
    fam: Counter = Counter()
    for name, d in raw.items():
        fam[op_family(name, names)] += d
    total = sum(fam.values())
    return total, [{"op": n, "ms": round(d / 1000, 4), "share": round(d / total, 4) if total else 0.0}
                   for n, d in fam.most_common(top)]


def summarize(path: str, top: int = 25) -> dict:
    """The op tables of one trace: ``device_total_ms`` and ``ops`` (CUDA
    kernels, copies and memsets by name), ``kernel_count``,
    ``cpu_total_ms`` and ``cpu_ops`` (the host's ops), ``event_count``
    (complete events of any kind)."""
    data = _load(path)
    ev = data.get("traceEvents", []) if isinstance(data, dict) else data
    device: Counter = Counter()
    cpu: Counter = Counter()
    events = kernels = 0
    for e in ev:
        if e.get("ph") != "X":
            continue
        events += 1
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device[e["name"]] += float(e.get("dur", 0))
            kernels += cat == "kernel"
        elif cat == "cpu_op":
            cpu[e["name"]] += float(e.get("dur", 0))
    dev_total, ops = _table(device, top)
    cpu_total, cpu_ops = _table(cpu, top)
    return {
        "trace": path,
        "device_total_ms": round(dev_total / 1000, 4),
        "kernel_count": kernels,
        "event_count": events,
        "ops": ops,
        "cpu_total_ms": round(cpu_total / 1000, 4),
        "cpu_ops": cpu_ops,
    }


def summarize_host_trace(path: str) -> list[dict]:
    """The obs span tracer's Chrome trace-event file grouped by span name
    (a dict with ``traceEvents`` or a bare list; instant events count
    occurrences only)."""
    data = _load(path)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    agg: dict[str, dict] = defaultdict(lambda: {"count": 0, "us": 0.0})
    for e in events:
        if e.get("ph") not in ("X", "i"):
            continue
        a = agg[e["name"]]
        a["count"] += 1
        a["us"] += float(e.get("dur", 0.0))
    return [{"span": n, "count": a["count"], "total_ms": round(a["us"] / 1000, 3),
             "mean_ms": round(a["us"] / 1000 / a["count"], 3)}
            for n, a in sorted(agg.items(), key=lambda kv: -kv[1]["us"])]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("trace", help="a torch.profiler Chrome trace (.json / .json.gz) or a directory holding one")
    p.add_argument("--host-trace", default=None, metavar="PATH",
                   help="Chrome trace-event JSON from the train CLI's --trace-events; its spans join the report")
    p.add_argument("--json", action="store_true", help="emit ONE machine-readable JSON document")
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)
    if not os.path.exists(args.trace):
        print(f"error: trace path {args.trace!r} does not exist (run the train CLI with --profile-dir DIR, or "
              "GET /profile, first)", file=sys.stderr)
        return 1
    path = args.trace if os.path.isfile(args.trace) else find_trace_json(args.trace)
    if path is None:
        print(f"error: no Chrome trace under {args.trace!r}", file=sys.stderr)
        return 1
    out = summarize(path, args.top)
    if args.host_trace:
        try:
            out["host_spans"] = summarize_host_trace(args.host_trace)
        except (OSError, json.JSONDecodeError, KeyError, TypeError) as e:
            print(f"error: --host-trace {args.host_trace!r}: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    print(f"trace: {out['trace']}")
    print(f"device total: {out['device_total_ms']} ms in {out['kernel_count']} kernels")
    for o in out["ops"]:
        print(f"{o['ms']:12.4f} ms  {100 * o['share']:5.1f}%  {o['op']}")
    print(f"host ops total: {out['cpu_total_ms']} ms")
    for o in out["cpu_ops"][:10]:
        print(f"{o['ms']:12.4f} ms  {100 * o['share']:5.1f}%  {o['op']}")
    for s in out.get("host_spans", []):
        print(f"{s['total_ms']:10.2f} ms  x{s['count']:<5d} mean {s['mean_ms']:8.3f} ms  {s['span']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
