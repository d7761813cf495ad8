"""Analytic per-device memory accounting for every config x scale: the
port's copy of the reference's ``tools/hbm_model.py`` (``predict``), over
the port's own layouts.

Components, per worker:

- state (EXACT, from tensor shapes, no device): params, model_state (BN
  statistics), optimizer state, gossip state (CHOCO xhat/s, overlap
  correction, push-sum mass), SlowMo outer — the optimizer and gossip
  states built by the port's own ``optimizer.init`` and
  ``ConsensusEngine.init_state`` on ``meta`` tensors of one worker's
  parameters;
- round batch (exact): one worker's ``(h, B, ...)`` slice of the
  config's own batch;
- codec transients: CHOCO's delta / decompressed-innovation temporaries
  (2x the gossiped subtree in f32) plus payload send+recv buffers
  (``wire_bytes_per_round`` x (1 + neighbour shifts));
- activations (MODELED): the reference's per-family formulas and
  coefficients, unchanged.

Peak model, as the reference's::

    peak ~= state + batch + max(activations, codec_transients) + payloads

Differences from the reference's layouts, each named:

- **frozen base held once**: a LoRA run's base (``llama_lora``) is not in
  ``params`` (the adapters alone are stacked and trained); it is its own
  component, ``frozen``, in its held dtypes (bf16 Dense kernels and
  embedding, f32 norm scales), counted once per device whatever the
  world. The reference counts the base in every worker's f32 ``params``.
- **the simulated backend stacks every worker on one card**: ``predict``
  models ONE worker, as the reference's; the trainer multiplies by the
  world on the simulated backend (the frozen base once), as the
  reference's ``train.py`` does.
- ``model_axes`` (tensor parallelism), the reference's: each state leaf
  is divided by the sizes of the axes its rule names (the config's
  ``tp_rules``, ``parallel/sharding.py``), the frozen base too (the port
  splits it by the same rules), and the activations by the product of the
  sizes; the gossip state's bucket buffers match no rule and stay whole,
  as the reference's do. ``model_axes=None`` takes the config's default
  (``llama_lora`` full: tp 4), as the reference's ``predict`` does.

Usage::

    python consensusml_tpu_torch/tools/hbm_model.py --config gpt2_topk --scale full
    python consensusml_tpu_torch/tools/hbm_model.py --all
    python consensusml_tpu_torch/tools/hbm_model.py --config mnist_mlp --reconcile   # the three-way (card)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

GIB = 1024**3

# activation-model coefficients: the reference's (tools/hbm_model.py)
_SAVED_PER_LAYER_HIDDEN = 8  # hidden-sized bf16 residuals saved per layer
_SAVED_PER_LAYER_MLP = 2  # mlp-sized bf16 residuals saved per layer
_HEAD_LOGITS_F32 = 2.0  # logits + softmax/CE residuals, in B*S*V f32 units
_RESNET_SAVED_PER_CONV = 1.6  # conv output + BN/ReLU residuals, bf16 units


def _bytes(tensors) -> int:
    return sum(math.prod(t.shape) * t.element_size() for t in tensors)


def _tp_divider(bundle, model_axes):
    """``(name, tensor) -> shard count`` from the bundle's own rules (the
    reference's ``_tp_divider``), or None without model axes."""
    if not model_axes or bundle.tp_rules is None:
        return None
    from consensusml_tpu_torch.parallel.sharding import spec_for_path, tree_path

    sizes = dict(model_axes)
    rules = bundle.tp_rules()  # default axis names, as WorkerMesh uses

    def divide(name: str, t) -> int:
        spec = spec_for_path(tree_path(name), len(t.shape), rules)
        return math.prod(sizes.get(ax, 1) for ax in spec if ax is not None)

    return divide


def _named_bytes(named, divide=None) -> int:
    """Bytes of ``(name, tensor)`` pairs, each divided by its shard count."""
    return sum(math.prod(t.shape) * t.element_size() // (divide(n, t) if divide else 1) for n, t in named)


def _transformer_act(B, S, hidden, mlp, layers, vocab, heads, mlp_tensors=_SAVED_PER_LAYER_MLP) -> int:
    """The reference's decoder/encoder activation residuals, bf16 compute."""
    per_layer = B * S * (_SAVED_PER_LAYER_HIDDEN * hidden + mlp_tensors * mlp) * 2 + B * heads * S * 4
    embed = 3 * B * S * hidden * 2
    head = int(_HEAD_LOGITS_F32 * B * S * vocab * 4)
    return layers * per_layer + embed + head


def _resnet_act(model, image: int, B: int) -> int:
    """The reference's walk: every conv's output map, bf16, times the
    saved-residual coefficient."""
    w = model.width
    hw = image
    total = 0
    if model.stem == "imagenet":
        hw //= 2
        total += hw * hw * w
        hw //= 2
    else:
        total += hw * hw * w
    bottleneck = type(model.blocks[0]).__name__ == "BottleneckBlock"
    for i, n_blocks in enumerate(model.stage_sizes):
        feats = w * (2**i)
        if i > 0:
            hw //= 2
        out_f = 4 * feats if bottleneck else feats
        for b in range(n_blocks):
            total += hw * hw * ((feats + feats + out_f) if bottleneck else 2 * feats)
            if b == 0:
                total += hw * hw * out_f
    return int(_RESNET_SAVED_PER_CONV * B * total * 2)


def _mlp_act(model, B, in_pixels) -> int:
    return B * (in_pixels + model.hidden + 10) * 4 * 2


def _activation_bytes(bundle, shapes) -> int:
    model = bundle.model
    name = type(model).__name__
    B = shapes["batch"]
    if name == "ResNet":
        return _resnet_act(model, shapes["image"], B)
    if name == "MLP":
        return _mlp_act(model, B, shapes["pixels"])
    c = model.config
    mlp = getattr(c, "mlp_dim", None) or 4 * c.hidden
    mlp_tensors = 3 if name == "LlamaLM" else _SAVED_PER_LAYER_MLP
    return _transformer_act(B, shapes["seq"], c.hidden, mlp, c.layers, c.vocab_size, c.heads,
                            mlp_tensors=mlp_tensors)


def _sample_shapes(bundle) -> dict:
    """Micro-batch geometry from one real round batch (a worker's slice)."""
    batch = next(iter(bundle.batches(1, 0)))
    leaf = batch["image"] if "image" in batch else batch["input_ids"]
    itemsize = lambda x: x.element_size() if hasattr(x, "element_size") else x.dtype.itemsize  # noqa: E731
    out = {
        "h": leaf.shape[1],
        "batch": leaf.shape[2],
        "batch_bytes": sum(math.prod(x.shape[1:]) * itemsize(x) for x in batch.values()),
    }
    if "image" in batch:
        out["image"] = leaf.shape[3]
        out["pixels"] = math.prod(leaf.shape[3:])
    else:
        out["seq"] = leaf.shape[3]
    return out


def _frozen_bytes(bundle, divide=None) -> int:
    """The LoRA base as ``TrainState.frozen`` holds it: every non-adapter
    leaf of the model, the norm scales f32, the rest in the compute
    dtype; a rank's pieces of it under ``divide``."""
    if bundle.draw_frozen is None:
        return 0
    from consensusml_tpu_torch.models.lora import is_lora_path

    dtype = bundle.model.config.dtype
    total = 0
    for n, p in bundle.model.named_parameters():
        if is_lora_path((n,)):
            continue
        size = 4 if n.endswith(".scale") else dtype.itemsize
        total += math.prod(p.shape) * size // (divide(n, p) if divide else 1)
    return total


def predict(name: str, scale: str = "full", world: int | None = None, model_axes=None) -> dict:
    """Per-device memory prediction for one config (one worker; one rank of
    it under ``model_axes``, ``None`` = the config's default). Pure host
    computation: draws one worker's initial parameters on the host for
    their shapes and builds nothing on a device."""
    import torch

    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.train.outer import slowmo_init
    from consensusml_tpu_torch.utils import tree as T

    bundle = configs.build(name, scale, world=world, device="cpu")
    axes = bundle.model_axes if model_axes is None else tuple(tuple(a) for a in model_axes)
    tp = math.prod(s for _, s in axes) if axes else 1
    divide = _tp_divider(bundle, axes)
    cfg = bundle.cfg
    engine = cfg.engine()
    p0, ms0 = bundle.convert(bundle.init_params(0, ranks=[0]))
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    params = {n: meta(t) for n, t in p0.items()}  # (1, ...): one worker, stacked
    model_state = T.tree_map(meta, ms0)
    del p0, ms0
    opt_state = cfg.optimizer.init(params, 1)
    gossiped = {"params": params, "model_state": model_state}
    gossip = engine.init_state(gossiped, world_size=1)
    outer = slowmo_init(params) if cfg.outer is not None else None
    state = {
        "params": _named_bytes(params.items(), divide),
        "model_state": _named_bytes(T.named_tensors(model_state), divide),
        "opt": _named_bytes(T.named_tensors(opt_state), divide),
        "gossip": _named_bytes(T.named_tensors(gossip), divide) if gossip is not None else 0,
        "outer": _named_bytes(T.named_tensors(outer), divide) if outer is not None else 0,
        "frozen": _frozen_bytes(bundle, divide),
    }
    shapes = _sample_shapes(bundle)
    if cfg.gossip.compressor is not None:
        per_worker = T.tree_map(lambda t: torch.empty(t.shape[1:], dtype=t.dtype, device="meta"), gossiped)
        sel, _ = engine._select(per_worker)
        n_gossiped = sum(math.prod(x.shape) for x in T.leaves(sel))
        wire = engine.wire_bytes_per_round(per_worker)
        topo = cfg.gossip.topology
        shifts = 1 if topo.uses_psum else len(topo.shifts)
        codec = {"codec_temp": 2 * n_gossiped * 4, "payloads": wire * (1 + shifts)}
    else:
        codec = {"codec_temp": 0, "payloads": 0}
    act = _activation_bytes(bundle, shapes) // tp
    total = sum(state.values()) + shapes["batch_bytes"] + max(act, codec["codec_temp"]) + codec["payloads"]
    return {
        "config": name,
        "scale": scale,
        "world": bundle.world_size,
        "model_axes": [list(a) for a in axes],
        "per_device": {**state, "batch": shapes["batch_bytes"], "activations": act, **codec},
        "predicted_peak_bytes": int(total),
        "predicted_peak_gib": round(total / GIB, 3),
    }


def stacked_bytes(pred: dict, world: int) -> int:
    """The simulated backend's card: every worker's share stacked, the
    frozen base once."""
    frozen = pred["per_device"]["frozen"]
    return int((pred["predicted_peak_bytes"] - frozen) * world + frozen)


_ALL = ["mnist_mlp", "cifar_resnet50", "bert_mlm", "gpt2_topk", "llama_lora"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None, choices=_ALL)
    ap.add_argument("--scale", default=None, choices=("smoke", "full"))
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reconcile", action="store_true",
                    help="run the three-way reconciliation (analytic vs the counted train step vs the live peak) "
                         "through obs/memviz.reconcile_config on the card and print its doc")
    args = ap.parse_args(argv)
    if args.scale is None:
        args.scale = "smoke" if args.reconcile else "full"
    if args.reconcile:
        if not args.config:
            ap.error("--reconcile needs --config NAME")
        from consensusml_tpu_torch.obs.memviz import reconcile_config

        print(json.dumps(reconcile_config(args.config, args.scale), indent=2))
        return 0
    names = _ALL if args.all else [args.config]
    if names[0] is None:
        ap.error("pass --config NAME or --all")
    print(json.dumps([predict(n, args.scale, world=args.world) for n in names], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
