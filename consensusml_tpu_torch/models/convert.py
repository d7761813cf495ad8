"""Parameter conversion between the JAX package's flax trees and the port.

The port's ``GPT2LM`` mirrors the flax tree one for one (module path =
flax path joined by dots, same shapes, f32), so conversion is a flatten:
no transposes, no reshapes. The input is the flax ``params`` tree with
every leaf already a numpy array (``jax.tree.map(np.asarray, params)``),
so this module needs neither JAX nor flax.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from consensusml_tpu_torch.utils import tree as T

__all__ = ["gpt2_from_flax"]


def gpt2_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``GPT2LM`` params (numpy leaves) -> a state dict for
    :class:`consensusml_tpu_torch.models.gpt2.GPT2LM` (f32 tensors, keys
    in the reference's flatten order). A leading worker axis, if every
    leaf has one, is kept: the result is then the trainer's stacked
    parameter dict."""
    return {".".join(path): _tensor(leaf) for path, leaf in T.flatten_with_paths(params)}


def _tensor(leaf) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(leaf, dtype=np.float32))
    if not arr.flags.writeable:  # arrays exported by JAX are read-only
        arr = arr.copy()
    return torch.from_numpy(arr)
