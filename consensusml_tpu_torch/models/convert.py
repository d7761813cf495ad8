"""Parameter conversion from the JAX package's flax trees.

The input is the flax ``params`` tree of ``consensusml_tpu``'s ``GPT2LM``
with every leaf already a numpy array (``jax.tree.map(np.asarray,
params)``), so this module needs neither JAX nor flax.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["gpt2_from_flax"]


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def gpt2_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``GPT2LM`` params (numpy leaves) -> a state dict for
    :class:`consensusml_tpu_torch.models.gpt2.GPT2LM` (f32 tensors;
    ``load_state_dict`` casts them to the model's dtype, which matches
    flax's per-op cast of f32 parameters).

    Layouts: ``qkv`` is ``DenseGeneral((heads, 3*d_head))`` with kernel
    ``(hidden, heads, 3*d_head)`` — flattened per head, so each head's
    q | k | v stay together; ``out`` is ``DenseGeneral(hidden,
    axis=(-2, -1))`` with kernel ``(heads, d_head, hidden)``; Dense
    kernels are ``(in, out)`` and transpose to PyTorch's ``(out, in)``.
    """
    sd = {
        "wte": _t(params["wte"]["embedding"]),
        "wpe": _t(params["wpe"]["embedding"]),
        "ln_f.scale": _t(params["ln_f"]["scale"]),
        "ln_f.bias": _t(params["ln_f"]["bias"]),
    }
    layers = sorted(
        (k for k in params if k.startswith("h_")), key=lambda k: int(k[2:])
    )
    for i, name in enumerate(layers):
        p = params[name]
        if name != f"h_{i}":
            raise ValueError(f"layer names are not contiguous: expected h_{i}, got {name}")
        qkv = np.asarray(p["qkv"]["kernel"])  # (hidden, heads, 3*d_head)
        out = np.asarray(p["out"]["kernel"])  # (heads, d_head, hidden)
        pre = f"h.{i}."
        sd[pre + "qkv.weight"] = _t(qkv.reshape(qkv.shape[0], -1).T)
        sd[pre + "qkv.bias"] = _t(np.asarray(p["qkv"]["bias"]).reshape(-1))
        sd[pre + "out.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
        sd[pre + "out.bias"] = _t(p["out"]["bias"])
        for ln in ("ln_1", "ln_2"):
            sd[pre + ln + ".scale"] = _t(p[ln]["scale"])
            sd[pre + ln + ".bias"] = _t(p[ln]["bias"])
        for dense in ("mlp_in", "mlp_out"):
            sd[pre + dense + ".weight"] = _t(np.asarray(p[dense]["kernel"]).T)
            sd[pre + dense + ".bias"] = _t(p[dense]["bias"])
    return sd
