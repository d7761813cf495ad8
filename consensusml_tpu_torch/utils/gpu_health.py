"""CUDA liveness preflight (port of ``consensusml_tpu/utils/tpu_health.py``).

A card can wedge so that a process's first CUDA call blocks instead of
raising (a hung CUDA stack, a card lost under a previous job), and an entry
point that initialises CUDA in-process then hangs past its budget with
nothing said. :func:`probe` never lets the CALLER's process touch CUDA
first: a disposable child initialises CUDA, makes one allocation and
synchronises, under a hard timeout, and reports alive/wedged plus the
card's name.

Used by the train CLI (``python -m consensusml_tpu_torch.train``) before
its first CUDA call when it runs on the card: a probe that fails exits 2
with the reason instead of hanging. The CLI skips it when this process
already holds a CUDA context (a library caller: the first call is behind
it) or when ``CONSENSUSML_SKIP_GPU_PROBE=1``. Standalone::

    python -m consensusml_tpu_torch.utils.gpu_health [--timeout S]

Test hooks (the reference's, renamed): ``GPU_HEALTH_CMD`` replaces the
child's ``-c`` program (an endless sleep fakes a wedged card) and
``GPU_HEALTH_TIMEOUT`` overrides the default timeout, so the hang path
is testable without a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_MARK = "GPU_HEALTH "
SKIP_ENV = "CONSENSUSML_SKIP_GPU_PROBE"

# The child initialises CUDA, allocates one element and synchronises (the
# calls a wedged card blocks in), then prints one marked JSON line.
_CHILD = (
    "import json, torch\n"
    "ok = torch.cuda.is_available()\n"
    "n = torch.cuda.device_count() if ok else 0\n"
    "if ok:\n"
    "    torch.empty(1, device='cuda').fill_(1.0)\n"
    "    torch.cuda.synchronize()\n"
    "print('GPU_HEALTH ' + json.dumps({'platform': 'cuda' if ok else 'cpu', 'n_devices': n, "
    "'device_kind': torch.cuda.get_device_name(0) if ok else ''}))\n"
)


def probe(timeout: float | None = None) -> dict:
    """Probe CUDA in a subprocess; never hangs the caller.

    Returns a dict with keys:

    - ``alive`` — the child ran to its end in time;
    - ``gpu`` — ``alive`` and a CUDA device answered (allocated and
      synchronised);
    - ``platform`` (``"cuda"`` or ``"cpu"``) / ``n_devices`` /
      ``device_kind`` (the card's name) — from the child;
    - ``elapsed_s`` — wall clock spent probing; ``timeout_s``;
    - ``reason`` — a diagnostic when not ``alive``.
    """
    if timeout is None:
        timeout = float(os.environ.get("GPU_HEALTH_TIMEOUT", "120"))
    child = os.environ.get("GPU_HEALTH_CMD", _CHILD)
    out: dict = {"alive": False, "gpu": False, "platform": None, "n_devices": 0, "device_kind": "",
                 "timeout_s": timeout}
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-c", child], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        out["elapsed_s"] = round(time.time() - t0, 1)
        out["reason"] = (f"CUDA probe did not return within {timeout:.0f}s — the first CUDA call is hanging "
                         "(a wedged card?)")
        return out
    out["elapsed_s"] = round(time.time() - t0, 1)
    if proc.returncode != 0:
        out["reason"] = f"CUDA probe exited rc={proc.returncode}: {stderr.strip()[-400:]}"
        return out
    for line in stdout.splitlines():
        if line.startswith(_MARK):
            try:
                info = json.loads(line[len(_MARK):])
            except json.JSONDecodeError:
                out["reason"] = f"unparseable probe output: {line[:200]}"
                return out
            out.update(info)
            out["alive"] = True
            out["gpu"] = out.get("platform") == "cuda" and out.get("n_devices", 0) > 0
            return out
    out["reason"] = f"probe printed no {_MARK.strip()} line: {stdout[-200:]}"
    return out


def preflight() -> str | None:
    """The train CLI's guard before its first CUDA call: None when the
    probe is skipped (``CONSENSUSML_SKIP_GPU_PROBE=1``, or this process
    already holds a CUDA context) or the child ran to its end; else the
    ``error: ...`` line to exit 2 with. A child that ran but found no card
    is not an error here: the CLI's own refusal (no CUDA device) follows."""
    if os.environ.get(SKIP_ENV):
        return None
    import torch

    if torch.cuda.is_initialized():
        return None
    health = probe()
    if not health["alive"]:
        return f"error: --device cuda requested but the GPU probe failed: {health.get('reason', 'unknown')}"
    return None


def main(argv: list[str] | None = None) -> int:
    """CLI: print the probe JSON; rc 0 = a CUDA device alive, 1 = alive but
    no CUDA device (CPU only), 2 = wedged or errored."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--timeout", type=float, default=None,
                   help="probe timeout in seconds (default $GPU_HEALTH_TIMEOUT or 120)")
    args = p.parse_args(argv)
    result = probe(timeout=args.timeout)
    print(json.dumps(result))
    if not result["alive"]:
        return 2
    return 0 if result["gpu"] else 1


if __name__ == "__main__":
    sys.exit(main())
