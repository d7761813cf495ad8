"""The round loop's bookkeeping that the train CLI's two backends share:
what a round line and a JSONL record add for the LR flags, when a
periodic eval and a checkpoint fall due, the eval lines, and the
watchdog."""

from __future__ import annotations

import numpy as np

from consensusml_tpu_torch.train.optim import clip_norms, latest_lr

__all__ = ["lr_flags_set", "train_extras", "extras_text", "due", "eval_text", "start_watchdog"]


def lr_flags_set(spec: dict) -> bool:
    """Whether any of ``--lr``, ``--lr-schedule``, ``--warmup-rounds`` and
    ``--grad-clip`` was given (the parsed flags as a dict)."""
    return (spec.get("lr") is not None or spec.get("lr_schedule") is not None
            or spec.get("warmup_rounds", 0) > 0 or spec.get("grad_clip", 0.0) > 0)


def train_extras(spec: dict, optimizer, opt_state) -> dict:
    """The round's learning rate (worker 0's latest step) with an LR flag,
    and with clipping the largest pre-clip global norm over the workers
    (``grad_norm``) and how many workers' latest step was clipped."""
    out = {}
    if lr_flags_set(spec):
        out["lr"] = latest_lr(optimizer, opt_state)
    norms = clip_norms(optimizer, opt_state)
    if norms is not None:
        n = norms.detach().cpu().numpy()
        out["grad_norm"] = float(n.max())
        out["clipped"] = int(np.sum(n >= spec["grad_clip"]))
    return out


def extras_text(extras: dict) -> str:
    return "".join([f" lr {extras['lr']:.6g}" if "lr" in extras else "",
                    f" grad_norm {extras['grad_norm']:.6g} clipped {extras['clipped']}" if "grad_norm" in extras else ""])


def due(every: int, rnd: int) -> bool:
    """Whether a ``--eval-every`` or ``--checkpoint-every`` of ``every``
    rounds falls after round ``rnd`` (0: never)."""
    return every > 0 and (rnd + 1) % every == 0


def eval_text(result: dict, rnd: int | None) -> str:
    """The reference's two eval lines, tagged ``[round r]`` mid-run."""
    fmt = lambda d: " ".join(f"{k}={float(v):.4f}" for k, v in sorted(d.items()))  # noqa: E731
    tag = f"[round {rnd}] " if rnd is not None else ""
    return f"{tag}eval[mean-model]: {fmt(result['mean_model'])}\n{tag}eval[worker-avg]: {fmt(result['worker_mean'])}"


def start_watchdog(timeout: float, on_timeout=None):
    """A started :class:`~consensusml_tpu_torch.utils.watchdog.ProgressWatchdog`
    of ``timeout`` seconds, or None for 0; ``on_timeout(reason)`` runs
    before its exit (the flight recorder's dump)."""
    if not timeout or timeout <= 0:
        return None
    from consensusml_tpu_torch.utils.watchdog import ProgressWatchdog

    return ProgressWatchdog(timeout, label="train round", on_timeout=on_timeout).start()
