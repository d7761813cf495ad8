"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` (or ``"cuda"``) means the current CUDA device, with its
    index. Without a GPU that raises
    rather than falling back to the CPU: the CPU is only ever used when
    the caller asks for it (``device="cpu"``, as the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" names the current card: an index, as torch.cuda.set_device needs
        return torch.device("cuda", torch.cuda.current_device())
    return dev
