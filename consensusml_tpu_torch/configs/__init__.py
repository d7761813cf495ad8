"""Run configurations of the port (counterpart of ``consensusml_tpu.configs``).

``cifar_resnet50`` is the reference's ``_cifar_resnet50``
(``consensusml_tpu/configs/__init__.py:278-325``): ResNet-50 consensus
SGD on a ring with exact (uncompressed) bucketed gossip of the weights
and the BN statistics, ``optax.sgd(lr, momentum=0.9)``, h = 1, on
``SyntheticClassification(noise=0.25)``:

- ``scale="full"``: ``resnet50(num_classes=10, stem="cifar")`` (bf16
  compute, f32 params and statistics), 8 workers, batch 128 of 32x32x3
  from n = 4096 images, lr 0.1;
- ``scale="smoke"``: ``ResNet([1, 1], BottleneckBlock, width 8, f32)``,
  8 workers, batch 8 of 16x16x3 from n = 512, lr 0.05.

``norm_impl`` is the model's own field, ``"flax"`` by default as in the
reference (PyTorch's batch norm); ``"pallas"`` runs every BN through the
fused-BN CUDA kernels.

``gpt2_topk`` is the reference's ``_gpt2_topk``
(``consensusml_tpu/configs/__init__.py:443-512``): GPT-2 pretraining by
CHOCO compressed gossip on a ring.

- ``scale="full"``: GPT-2-medium (24 layers, hidden 1024, 16 heads,
  vocab 50257, max_len 1024, dropout 0.1), 8 workers by default, batch
  8 x seq 1024, h = 2 local Adam(1e-4) steps per round, gamma 0.1, 50
  exact warm-up rounds and a dense refresh every 50;
- ``scale="smoke"``: the tiny test model (vocab 64, hidden 32, 2 layers,
  2 heads, max_len 32, dropout 0), 4 workers, batch 8 x seq 16, h = 2,
  Adam(3e-3), gamma 0.5, no warm-up or refresh.

Codecs (``codec=None`` is the config's own, as ``train.py`` without
``--codec``):

- ``"topk_int8"``, the config's: ``topk_int8_compressor(chunk=512, k=8)``
  full, ``topk_int8_compressor(ratio=0.1, chunk=128)`` (13 of 128) smoke;
  chunked top-k then int8 on the values, on the two-step bucketed wire
  (four kernels an exchange: top-k, quantize, dequantize, scatter);
- ``"topk_int4"``, the reference's ``train.py --codec topk_int4``: the
  same chunk and k with int4 values (``topk_int4_compressor``, the int4
  stage ``PallasInt4Compressor``), on the two-step wire (top-k, int4
  quantize, int4 dequantize, scatter);
- ``"int8"``, ``"int4"`` and ``"fp8"``, the reference's ``train.py
  --codec int8|int4|fp8``: ``PallasInt8Compressor``,
  ``PallasInt4Compressor`` or ``PallasFp8Compressor`` at the config's
  chunk rounded up to 128, which ride the fused one-pass bucketed wire
  (one encode launch a bucket an exchange).

``norm_impl`` is GPT-2's own field (``GPT2Config.norm_impl``): ``"flax"``
(the default) or ``"pallas"``, every LayerNorm through the fused-LN CUDA
kernels (their plain versions on the CPU); ``"jnp"``, the fused LN's plain
versions on any device.

``mnist_mlp`` is the reference's ``_mnist_mlp``
(``consensusml_tpu/configs/__init__.py:241-275``): a 2-layer MLP (hidden
256 full, 64 smoke; f32) on ``SyntheticClassification(n=8192 full, 2048
smoke, 28x28x1)``, 4 workers, dense exact gossip, ``optax.adam(1e-3)``,
h = 1, batch 64. Its path launches none of the port's kernels: two dense
layers (cuBLAS) and a gossip ``W @ x``.

``bert_mlm`` is the reference's ``_bert_mlm``
(``consensusml_tpu/configs/__init__.py:328-366``): BERT masked-LM
pretraining by local SGD, h = 8 local Adam steps a round, then one round
of exact (uncompressed) bucketed gossip on a ring, on ``SyntheticLM``
corrupted at ``mlm_rate`` 0.15 (mask token ``vocab - 1``):

- ``scale="full"``: BERT-base (12 layers, hidden 768, 12 heads, MLP
  3072, vocab 30522, dropout 0.1, bf16 compute), 32 workers, batch 32 x
  seq 128, Adam(1e-4);
- ``scale="smoke"``: vocab 64, hidden 32, 2 layers, 2 heads, MLP 64,
  max_len 32, dropout 0, 4 workers, batch 8 x seq 16, Adam(1e-2).

At seq 128 its attention is dense (S*T <= 512^2), as the reference's; the
flash kernels with their per-key mask take the same encoder at a longer
``max_len`` with an ``attention_mask`` (``models.bert.bert_base``).

``llama_lora`` is the reference's ``_llama_lora``
(``consensusml_tpu/configs/__init__.py:369-440``): a LoRA fine-tune of a
Llama decoder by consensus SGD on a torus, h = 1 local step of
``lora_optimizer(adam(lr))`` a round, then one round of exact gossip of
the adapters only (``path_filter=lora_gossip_filter``), on ``SyntheticLM``:

- ``scale="full"``: Llama-2-7B (32 layers, hidden 4096, 32 heads of dim
  128, MLP 11008, vocab 32000, bf16 compute) with rank-16 adapters on q,
  k, v and o (alpha 16), 16 workers on a 4x4 torus, batch 8 x seq 2048,
  Adam(1e-3); attention through the flash kernels at head dim 128;
- ``scale="smoke"``: ``llama_tiny`` (vocab 256, hidden 64, 2 layers, 4
  heads and 2 kv heads of dim 16, MLP 128) with rank-4 adapters, 4
  workers on a 2x2 torus, batch 8 x seq 16, Adam(1e-2).

The base is the same on every worker (the reference draws it once from a
fixed key and never trains or gossips it), so the port holds it ONCE,
beside the stacked adapters (``RunBundle.draw_frozen``, uploaded a leaf at
a time by :func:`frozen_on_device`): its Dense kernels and embedding in
bf16, as the reference casts them before every product. The reference
runs each full-scale worker on a tp = 4 submesh (64 chips); the port runs
all 16 workers on one card without tensor parallelism, and takes each
worker's batch of 8 in micro-batches of 4 (``LocalSGDConfig.micro_batch``:
the same gradient of the 8 sequences, summed in another order).

Every bundle carries the reference's optimizer rebuild hook for the LR
flags (``--lr``, ``--lr-schedule``, ``--warmup-rounds``, ``--grad-clip``):
``optimizer_factory(lr_or_schedule)`` rebuilds exactly the config's
optimizer (``llama_lora``'s also takes ``grad_clip``, clipping inside the
LoRA mask) and ``base_lr`` is the rate the config bakes in. ``data_dir=``
(``--data-dir``) trains on files (:mod:`consensusml_tpu_torch.data.files`:
MNIST idx for ``mnist_mlp``, CIFAR-10 binaries for ``cifar_resnet50``, a
token file for the LMs, whose ids must stay below ``vocab - 1``), falling
back to the procedural data where the directory holds none.

Every config takes ``topology=``, ``train.py``'s ``--topology``:
``NAME[:k=v,...]`` (:func:`topology_from_spec`), the named family at the
run's world size in place of the config's own graph. Every bundle carries
the reference's held-out eval: ``eval_fn`` (top-1 for the classifiers,
next-token nll for GPT-2) and ``eval_batches(n, seed)``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import numpy as np
import torch

from consensusml_tpu_torch.device import resolve_device
from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM

__all__ = [
    "CONFIGS", "RunBundle", "build", "gpt2_config", "bert_config", "build_model", "gpt2_init_params",
    "resnet_model", "topology_from_spec", "with_topology", "with_gossip_flags", "with_train_flags", "FlagError",
    "worker_inits", "init_on_device", "llama_config", "frozen_on_device", "LLAMA_MICRO_BATCH",
]

CONFIGS = ("gpt2_topk", "cifar_resnet50", "mnist_mlp", "bert_mlm", "llama_lora")
# the rows of a full-scale llama_lora worker's batch of 8 that one forward
# and backward take: the largest the card holds (one worker step's peak,
# base and every worker's adapters and Adam state included: 34.6 GB at 2,
# 52.4 GB at 4 on an H100; 8 would need ~88 GB; PERF.md §4)
LLAMA_MICRO_BATCH = 4
CODECS = ("topk_int8", "topk_int4", "int8", "int4", "fp8")


def gpt2_config(scale: str = "smoke", dtype: torch.dtype = torch.bfloat16, norm_impl: str = "flax") -> GPT2Config:
    if scale == "full":
        return GPT2Config(dtype=dtype, norm_impl=norm_impl)
    if scale == "smoke":
        return GPT2Config(vocab_size=64, hidden=32, layers=2, heads=2, max_len=32, dropout=0.0,
                          dtype=dtype, norm_impl=norm_impl)
    raise ValueError(f"unknown scale {scale!r} (smoke|full)")


def build_model(
    name: str = "gpt2_topk",
    scale: str = "smoke",
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> GPT2LM:
    """The config's model on ``device`` (``None`` = CUDA; raises without a
    GPU) with random weights drawn from a generator seeded by ``seed``
    (``gpt2_topk``: the serving model)."""
    if name != "gpt2_topk":
        raise ValueError(f"build_model serves gpt2_topk only, got {name!r}")
    dev = resolve_device(device)
    model = GPT2LM(gpt2_config(scale, dtype), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.init_weights(gen).eval()


def gpt2_init_params(cfg: GPT2Config, seed: int, world_size: int, ranks=None) -> dict[str, np.ndarray]:
    """:func:`.models.convert.normal_init_params` of ``GPT2LM(cfg)``: the
    stacked ``(W, ...)`` f32 flax-layout parameters, numpy-seeded per
    worker by ``(seed, rank)``, for :func:`.models.convert.gpt2_from_flax`.
    ``ranks`` draws only those workers' rows (the same values), stacked in
    that order: a rank of the collective backend draws its own."""
    from consensusml_tpu_torch.models.convert import normal_init_params

    return normal_init_params(GPT2LM(cfg, device="meta"), seed, world_size, ranks)


def bert_config(scale: str = "smoke"):
    """``bert_mlm``'s model configuration at ``scale``."""
    from consensusml_tpu_torch.models.bert import BertConfig

    if scale == "full":
        return BertConfig()
    if scale == "smoke":
        return BertConfig(vocab_size=64, hidden=32, layers=2, heads=2, mlp_dim=64, max_len=32, dropout=0.0)
    raise ValueError(f"unknown scale {scale!r} (smoke|full)")


def llama_config(scale: str = "smoke"):
    """``llama_lora``'s model configuration at ``scale``."""
    from consensusml_tpu_torch.models.llama import LlamaConfig

    if scale == "full":
        return LlamaConfig(lora_rank=16)
    if scale == "smoke":
        return LlamaConfig(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2, mlp_dim=128, max_len=128,
                           lora_rank=4)
    raise ValueError(f"unknown scale {scale!r} (smoke|full)")


def resnet_model(scale: str = "smoke", norm_impl: str = "flax"):
    """``cifar_resnet50``'s model at ``scale``: structure only (``meta``),
    the parameters live in the train state."""
    from consensusml_tpu_torch.models.resnet import BottleneckBlock, ResNet, resnet50

    if scale == "full":
        return resnet50(num_classes=10, stem="cifar", norm_impl=norm_impl, device="meta")
    if scale == "smoke":
        return ResNet([1, 1], BottleneckBlock, num_classes=10, width=8, stem="cifar", dtype=torch.float32,
                      norm_impl=norm_impl, device="meta")
    raise ValueError(f"unknown scale {scale!r} (smoke|full)")


@dataclasses.dataclass
class RunBundle:
    """Everything a run needs, as the reference's ``RunBundle``."""

    name: str
    world_size: int
    cfg: Any  # train.local_sgd.LocalSGDConfig
    model: Any  # structure only (meta device); parameters live in the train state
    loss_fn: Callable
    batches: Callable  # (rounds, seed, start=0) -> iterator of stacked (W, H, B, ...) batches
    draw_init: Callable  # (seed, ranks) -> those ranks' rows of the stacked numpy variables in flax layout
    convert: Callable  # init_params' output -> (params, model_state) as stacked CPU tensors
    codec_path: str
    norm_path: str = ""
    description: str = ""
    eval_fn: Callable | None = None  # train.evaluate's metric sums for one model
    eval_batches: Callable | None = None  # (n_batches, seed) -> iterator of unstacked held-out batches
    # (device) -> (name, tensor) of each leaf every worker shares, never
    # trained or gossiped (a LoRA run's base), drawn and uploaded one at a
    # time; None: no such leaves
    draw_frozen: Callable | None = None
    # the LR flags' rebuild hook: factory(lr_or_schedule) rebuilds exactly
    # cfg.optimizer; base_lr is the rate the config bakes in
    optimizer_factory: Callable | None = None
    base_lr: float | None = None
    data_source: str = "synthetic"  # the data's origin: "synthetic" or a file reader's source

    def init_params(self, seed: int, ranks=None):
        """The stacked ``(W, ...)`` numpy initial variables in flax layout,
        numpy-seeded per worker by ``(seed, rank)``. ``ranks`` draws only
        those workers' rows (the same values), stacked in that order;
        ``ranks=None`` draws every worker's through :func:`worker_inits`,
        a few at once in threads, into one stacked tree."""
        if ranks is not None:
            return self.draw_init(seed, ranks)
        from consensusml_tpu_torch.utils import tree as T

        out = None
        for r, part in worker_inits(self, seed):
            if out is None:
                out = T.tree_map(lambda a: np.empty((self.world_size, *a.shape[1:]), a.dtype), part)
            for dst, src in zip(T.leaves(out), T.leaves(part)):
                dst[r] = src[0]
        return out


# workers whose initial parameters are drawn at once (numpy's generators
# fill their arrays outside the GIL)
_INIT_THREADS = 8


def worker_inits(bundle: RunBundle, seed: int):
    """``(rank, bundle.init_params(seed, ranks=[rank]))`` for every worker in
    rank order: each worker's rows of the stacked draw, the same values,
    up to ``_INIT_THREADS`` drawn at once in threads, so the host holds
    that many workers' parameters at a time (BERT-base: 438 MB each,
    where all 32 would be 14 GB)."""
    from concurrent.futures import ThreadPoolExecutor

    world = bundle.world_size
    threads = min(_INIT_THREADS, os.cpu_count() or 1)
    with ThreadPoolExecutor(threads) as pool:
        for lo in range(0, world, threads):
            ranks = range(lo, min(lo + threads, world))
            yield from zip(ranks, pool.map(lambda r: bundle.draw_init(seed, [r]), ranks))


def init_on_device(bundle: RunBundle, seed: int, device) -> tuple[dict, dict]:
    """``bundle.convert(bundle.init_params(seed))`` as stacked tensors on
    ``device``, drawn (:func:`worker_inits`) and uploaded a worker at a
    time."""
    from consensusml_tpu_torch.utils import tree as T

    world = bundle.world_size
    params = model_state = None
    for r, init in worker_inits(bundle, seed):
        p, ms = bundle.convert(init)
        if params is None:
            params = {n: torch.empty((world, *t.shape[1:]), dtype=t.dtype, device=device) for n, t in p.items()}
            model_state = T.tree_map(lambda t: torch.empty((world, *t.shape[1:]), dtype=t.dtype, device=device), ms)
        for n, t in p.items():
            params[n][r].copy_(t[0])
        for dst, src in zip(T.leaves(model_state), T.leaves(ms)):
            dst[r].copy_(src[0])
    return params, model_state


def frozen_on_device(bundle: RunBundle, device) -> dict[str, torch.Tensor]:
    """The bundle's frozen leaves on ``device``, held once (``{}`` for a
    config without them), drawn and uploaded a leaf at a time."""
    if bundle.draw_frozen is None:
        return {}
    return dict(bundle.draw_frozen(device))


def topology_from_spec(spec: str, world: int):
    """``train.py``'s ``--topology NAME[:k=v,...]`` (integer values, e.g.
    ``hierarchical:slices=2,outer_every=2``) as that family at ``world``
    workers; raises ``ValueError`` (or ``IndexError`` for an argument
    without ``=``) on a bad spec, with the reference's messages."""
    from consensusml_tpu_torch.topology import topology_from_name

    name, _, argstr = spec.partition(":")
    kwargs = dict((kv.split("=")[0].strip(), int(kv.split("=")[1])) for kv in argstr.split(",") if kv)
    return topology_from_name(name, world, **kwargs)


def with_topology(bundle: RunBundle, spec: str) -> RunBundle:
    """``bundle`` gossiping over the :func:`topology_from_spec` family at its
    world size in place of its config's own graph (in place; returned)."""
    gossip = dataclasses.replace(bundle.cfg.gossip, topology=topology_from_spec(spec, bundle.world_size))
    bundle.cfg = dataclasses.replace(bundle.cfg, gossip=gossip)
    return bundle


class FlagError(ValueError):
    """A flag combination the train CLI refuses with exit code 2 (the
    reference's ``error: ...`` lines)."""


def with_gossip_flags(bundle: RunBundle, *, drop_prob: float = 0.0, push_sum: bool = False,
                      gossip_steps: int | None = None, codec_refresh: int | None = None,
                      bucket_bytes: int | None = None, overlap: bool = False,
                      pipeline: int | None = None) -> RunBundle:
    """``train.py``'s ``--drop-prob``, ``--push-sum``, ``--gossip-steps``,
    ``--codec-refresh``, ``--bucket-bytes``, ``--overlap-gossip`` and
    ``--gossip-pipeline`` on ``bundle`` (in place; returned), in the
    reference's order and with its refusals: push-sum first (it is what
    makes faults legal on a directed graph), then the fault model
    (``FaultConfig(drop_prob)``, non-finite detection on; a compressed
    config or a directed graph without push-sum raises
    ``NotImplementedError``, as the reference's does), then the consensus
    iterations and refresh, then the bucket cap on the ``LocalSGDConfig``
    (0: the per-leaf wire), then overlap gossip and its pipeline depth.
    :class:`FlagError` for what the reference refuses with exit code 2:
    ``--push-sum`` on a compressed config, and a
    ``--gossip-steps``/``--codec-refresh``, ``--bucket-bytes``,
    ``--overlap-gossip`` or ``--gossip-pipeline`` the config takes not."""
    from consensusml_tpu_torch.consensus import FaultConfig

    gossip = bundle.cfg.gossip
    if push_sum and gossip.compressor is not None:
        raise FlagError("--push-sum is incompatible with a compressed-gossip config "
                        "(CHOCO tracking assumes row-stochastic mixing)")
    if push_sum:
        gossip = dataclasses.replace(gossip, push_sum=True)
    if drop_prob > 0:
        gossip = dataclasses.replace(gossip, faults=FaultConfig(drop_prob=drop_prob))
    overrides = {k: v for k, v in (("gossip_steps", gossip_steps), ("codec_refresh_every", codec_refresh))
                 if v is not None}
    if overrides:
        try:
            gossip = dataclasses.replace(gossip, **overrides)
        except (NotImplementedError, ValueError) as e:
            raise FlagError(f"--gossip-steps/--codec-refresh: {e}") from e
    cfg = dataclasses.replace(bundle.cfg, gossip=gossip)
    if bucket_bytes is not None:
        try:
            cfg = dataclasses.replace(cfg, bucket_bytes=bucket_bytes)
        except (NotImplementedError, ValueError) as e:
            raise FlagError(f"--bucket-bytes: {e}") from e
    if overlap:
        try:
            cfg = dataclasses.replace(cfg, gossip=dataclasses.replace(cfg.gossip, overlap=True))
        except NotImplementedError as e:
            raise FlagError(f"--overlap-gossip: {e}") from e
    if pipeline is not None:
        try:
            cfg = dataclasses.replace(cfg, gossip=dataclasses.replace(cfg.gossip, pipeline_depth=pipeline))
        except (NotImplementedError, ValueError) as e:
            raise FlagError(f"--gossip-pipeline: {e}") from e
    bundle.cfg = cfg
    return bundle


def with_train_flags(bundle: RunBundle, *, lr: float | None = None, lr_schedule: str | None = None,
                     warmup_rounds: int = 0, grad_clip: float = 0.0, slowmo_beta: float | None = None,
                     rounds: int = 0, sched_start: int = 0) -> RunBundle:
    """``train.py``'s ``--lr``, ``--lr-schedule``, ``--warmup-rounds``,
    ``--grad-clip`` and ``--slowmo-beta`` on ``bundle`` (in place;
    returned). Any LR flag rebuilds the optimizer through
    ``bundle.optimizer_factory``
    (:func:`~consensusml_tpu_torch.train.schedules.build_optimizer`), the
    schedule sized over ``(sched_start + rounds) * h`` steps (a resumed
    run's ``sched_start`` is its checkpoint's round, so the schedule
    continues where it stopped) with ``warmup_rounds * h`` of warmup. Then
    SlowMo at ``slowmo_beta``. :class:`FlagError` for what the reference
    refuses with exit code 2: a bad horizon or warmup, and SlowMo with
    overlap gossip."""
    import dataclasses as dc

    from consensusml_tpu_torch.train.outer import SlowMoConfig
    from consensusml_tpu_torch.train.schedules import build_optimizer

    if lr is not None or lr_schedule is not None or warmup_rounds > 0 or grad_clip > 0:
        if bundle.optimizer_factory is None:
            raise FlagError(f"config {bundle.name} has no optimizer factory; LR/clip flags are unavailable")
        h = bundle.cfg.h
        try:
            tx = build_optimizer(bundle.optimizer_factory, peak_lr=bundle.base_lr if lr is None else lr,
                                 kind=lr_schedule or "constant", total_steps=(sched_start + rounds) * h,
                                 warmup_steps=warmup_rounds * h, grad_clip=grad_clip)
        except ValueError as e:  # e.g. --warmup-rounds >= --rounds
            raise FlagError(str(e)) from e
        bundle.cfg = dc.replace(bundle.cfg, optimizer=tx)
    if slowmo_beta is not None:
        try:
            bundle.cfg = dc.replace(bundle.cfg, outer=SlowMoConfig(beta=slowmo_beta))
        except NotImplementedError as e:
            raise FlagError(f"--slowmo-beta: {e}") from e
    return bundle


def build(name: str = "gpt2_topk", scale: str = "smoke", *, world: int | None = None,
          codec: str | None = None, gamma: float | None = None,
          codec_warmup: int | None = None, norm_impl: str = "flax", topology: str | None = None,
          device=None, data_dir: str | None = None) -> RunBundle:
    """The run recipe of config ``name`` at ``scale`` with the reference's
    overrides (``world`` = ``--workers``, ``codec``, ``gamma``,
    ``codec_warmup`` = ``--codec-warmup``; ``norm_impl``, the model's
    field: BN for the ResNet, LayerNorm for GPT-2; ``topology`` =
    ``--topology``, a :func:`topology_from_spec` spec; ``data_dir`` =
    ``--data-dir``). ``device`` (``None`` = CUDA; raises without a GPU)
    resolves the kernel paths: the CUDA kernels on a CUDA device, their
    plain versions on the CPU."""
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r} (one of {CONFIGS})")
    if scale not in ("smoke", "full"):
        raise ValueError(f"unknown scale {scale!r} (smoke|full)")
    dev = resolve_device(device)
    if name in ("cifar_resnet50", "mnist_mlp", "bert_mlm", "llama_lora"):
        if (codec, gamma, codec_warmup) != (None, None, None):
            raise NotImplementedError(f"{name} gossips exactly; its compressed variants are not ported yet")
        if name == "llama_lora":
            if norm_impl != "flax":
                raise ValueError(f"llama_lora's norms are RMSNorms (norm_impl must be 'flax', got {norm_impl!r})")
            bundle = _llama_lora(scale, world, data_dir)
        elif name == "mnist_mlp":
            if norm_impl != "flax":
                raise ValueError(f"mnist_mlp has no norm layers (norm_impl must be 'flax', got {norm_impl!r})")
            bundle = _mnist_mlp(scale, world, data_dir)
        elif name == "bert_mlm":
            if norm_impl != "flax":
                raise ValueError(f"bert_mlm's LayerNorms are flax's (norm_impl must be 'flax', got {norm_impl!r})")
            bundle = _bert_mlm(scale, world, data_dir)
        else:
            bundle = _cifar_resnet50(scale, world, norm_impl, dev, data_dir)
    else:
        bundle = _gpt2_topk(scale, world, codec, gamma, codec_warmup, norm_impl, dev, data_dir)
    return bundle if topology is None else with_topology(bundle, topology)


def _file_tokens(data_dir: str | None, seq: int, vocab: int):
    """A token file's dataset from ``data_dir``, or None. Its ids are
    checked, on at most the first million, to fit the vocabulary with the
    last id kept for [MASK]."""
    if data_dir is None:
        return None
    from consensusml_tpu_torch.data.files import load_tokens

    data = load_tokens(data_dir, seq_len=seq, vocab_size=vocab)
    if data is None:
        return None
    probe = np.asarray(data.tokens[:1_000_000])
    if probe.size and int(probe.max()) >= vocab - 1:
        raise ValueError(
            f"{data.source}: token id {int(probe.max())} >= vocab-1={vocab - 1} (the last vocab slot is "
            "reserved as [MASK]); retokenize or pick a config with a larger vocab"
        )
    return data


def _lm_batches(data, world: int, h: int, batch: int, mlm_rate: float = 0.0):
    """The round-batch closure of either LM source: the procedural stream
    or a token file's windows."""
    from consensusml_tpu_torch.data import lm_round_batches
    from consensusml_tpu_torch.data.files import TokenFileDataset, token_round_batches

    fn = token_round_batches if isinstance(data, TokenFileDataset) else lm_round_batches
    return lambda rounds, seed, start=0: fn(data, world, h, batch, rounds, seed, start=start, mlm_rate=mlm_rate)


def _source(data) -> str:
    return getattr(data, "source", "synthetic")


def _mnist_mlp(scale: str, world: int | None, data_dir: str | None = None) -> RunBundle:
    from consensusml_tpu_torch.consensus import GossipConfig
    from consensusml_tpu_torch.data import SyntheticClassification, cls_eval_batches, round_batches
    from consensusml_tpu_torch.models.convert import mlp_from_flax, mlp_init_params
    from consensusml_tpu_torch.models.mlp import MLP, mlp_loss_fn
    from consensusml_tpu_torch.topology import topology_from_name
    from consensusml_tpu_torch.train.evaluate import classification_eval_fn
    from consensusml_tpu_torch.train.local_sgd import LocalSGDConfig
    from consensusml_tpu_torch.train.optim import adam

    full = scale == "full"
    world = world or 4
    model = MLP(hidden=256 if full else 64, device="meta")
    opt, base_lr = adam, 1e-3
    cfg = LocalSGDConfig(gossip=GossipConfig(topology=topology_from_name("dense", world)), optimizer=opt(base_lr), h=1)
    data = None
    if data_dir is not None:
        from consensusml_tpu_torch.data.files import load_mnist

        data = load_mnist(data_dir)
    data = data or SyntheticClassification(n=8192 if full else 2048, image_shape=(28, 28, 1))
    batch = 64
    return RunBundle(
        name="mnist_mlp",
        world_size=world,
        cfg=cfg,
        model=model,
        loss_fn=mlp_loss_fn(model),
        batches=lambda rounds, seed, start=0: round_batches(data, world, cfg.h, batch, rounds, seed, start=start),
        draw_init=lambda seed, ranks: mlp_init_params(model, seed, world, ranks),
        convert=mlp_from_flax,
        codec_path="none (exact gossip)",
        description="2-layer MLP, 4 workers, dense gossip (CPU reference config)",
        eval_fn=classification_eval_fn(model),
        eval_batches=lambda n_batches, seed: cls_eval_batches(data, batch, n_batches, seed),
        optimizer_factory=opt,
        base_lr=base_lr,
        data_source=_source(data),
    )


def _bert_mlm(scale: str, world: int | None, data_dir: str | None = None) -> RunBundle:
    from consensusml_tpu_torch.consensus import GossipConfig
    from consensusml_tpu_torch.data import SyntheticLM, lm_eval_batches
    from consensusml_tpu_torch.models.bert import BertMLM, bert_mlm_loss_fn
    from consensusml_tpu_torch.models.convert import bert_from_flax, normal_init_params
    from consensusml_tpu_torch.topology import topology_from_name
    from consensusml_tpu_torch.train.evaluate import mlm_eval_fn
    from consensusml_tpu_torch.train.local_sgd import LocalSGDConfig
    from consensusml_tpu_torch.train.optim import adam

    full = scale == "full"
    mcfg = bert_config(scale)
    world = world or (32 if full else 4)
    batch, seq = (32, 128) if full else (8, 16)
    mlm_rate = 0.15
    opt, base_lr = adam, 1e-4 if full else 1e-2
    cfg = LocalSGDConfig(gossip=GossipConfig(topology=topology_from_name("ring", world)), optimizer=opt(base_lr), h=8)
    data = _file_tokens(data_dir, seq, mcfg.vocab_size) or SyntheticLM(vocab_size=mcfg.vocab_size, seq_len=seq)
    model = BertMLM(mcfg, device="meta")
    return RunBundle(
        name="bert_mlm",
        world_size=world,
        cfg=cfg,
        model=model,
        loss_fn=bert_mlm_loss_fn(model),
        batches=_lm_batches(data, world, cfg.h, batch, mlm_rate=mlm_rate),
        draw_init=lambda seed, ranks: normal_init_params(model, seed, world, ranks),
        convert=lambda init: (bert_from_flax(init), {}),
        codec_path="none (exact gossip)",
        norm_path="flax LayerNorm (post-LN, f32)",
        description=f"BERT MLM, local-SGD H=8 + ring averaging; seq {seq}: dense attention",
        eval_fn=mlm_eval_fn(model),
        eval_batches=lambda n_batches, seed: lm_eval_batches(data, batch, n_batches, seed, mlm_rate=mlm_rate),
        optimizer_factory=opt,
        base_lr=base_lr,
        data_source=_source(data),
    )


def _llama_lora(scale: str, world: int | None, data_dir: str | None = None) -> RunBundle:
    from consensusml_tpu_torch.consensus import GossipConfig
    from consensusml_tpu_torch.data import SyntheticLM, lm_eval_batches
    from consensusml_tpu_torch.models.convert import llama_adapter_params, llama_base_leaves, llama_from_flax
    from consensusml_tpu_torch.models.llama import LlamaLM, llama_loss_fn
    from consensusml_tpu_torch.models.lora import lora_gossip_filter
    from consensusml_tpu_torch.topology import topology_from_name
    from consensusml_tpu_torch.train.evaluate import causal_lm_eval_fn
    from consensusml_tpu_torch.train.local_sgd import LocalSGDConfig
    from consensusml_tpu_torch.train.optim import adam, lora_optimizer

    full = scale == "full"
    mcfg = llama_config(scale)
    world = world or (16 if full else 4)
    batch, seq = (8, 2048) if full else (8, 16)
    topo = topology_from_name("torus", world)
    rows, cols = topo.mesh_shape

    def opt(lr, grad_clip: float = 0.0):
        # the clip inside the LoRA mask: the norm covers the trained
        # adapters, not the frozen base
        return lora_optimizer(adam(lr), grad_clip=grad_clip)

    base_lr = 1e-3 if full else 1e-2
    cfg = LocalSGDConfig(
        gossip=GossipConfig(topology=topo, path_filter=lora_gossip_filter),
        optimizer=opt(base_lr),
        h=1,
        micro_batch=LLAMA_MICRO_BATCH if full else 0,
    )
    data = _file_tokens(data_dir, seq, mcfg.vocab_size) or SyntheticLM(vocab_size=mcfg.vocab_size, seq_len=seq)
    model = LlamaLM(mcfg, device="meta")
    threads = min(_INIT_THREADS, os.cpu_count() or 1)
    return RunBundle(
        name="llama_lora",
        world_size=world,
        cfg=cfg,
        model=model,
        loss_fn=llama_loss_fn(model),
        batches=_lm_batches(data, world, cfg.h, batch),
        draw_init=lambda seed, ranks: llama_adapter_params(model, seed, world, ranks),
        convert=lambda init: (llama_from_flax(init), {}),
        codec_path="none (exact gossip of the LoRA adapters only)",
        norm_path="RMSNorm (f32)",
        description=f"Llama LoRA fine-tune, {rows}x{cols} torus gossip (adapters-only wire)",
        eval_fn=causal_lm_eval_fn(model, deterministic_kwarg=False),
        eval_batches=lambda n_batches, seed: lm_eval_batches(data, batch, n_batches, seed),
        draw_frozen=lambda device: llama_base_leaves(model, device, mcfg.dtype, threads),
        optimizer_factory=opt,
        base_lr=base_lr,
        data_source=_source(data),
    )


def _cifar_resnet50(scale: str, world: int | None, norm_impl: str, dev: torch.device,
                    data_dir: str | None = None) -> RunBundle:
    from consensusml_tpu_torch.consensus import GossipConfig
    from consensusml_tpu_torch.data import SyntheticClassification, cls_eval_batches, round_batches
    from consensusml_tpu_torch.models.convert import resnet_from_flax, resnet_init_params
    from consensusml_tpu_torch.models.resnet import NORM_IMPLS, resnet_loss_fn
    from consensusml_tpu_torch.topology import topology_from_name
    from consensusml_tpu_torch.train.evaluate import classification_eval_fn
    from consensusml_tpu_torch.train.local_sgd import LocalSGDConfig
    from consensusml_tpu_torch.train.optim import sgd

    if norm_impl not in NORM_IMPLS:
        raise ValueError(f"unknown norm_impl {norm_impl!r} (one of {NORM_IMPLS})")
    full = scale == "full"
    world = world or 8
    batch, image = (128, 32) if full else (8, 16)

    def opt(lr):
        return sgd(lr, momentum=0.9)

    base_lr = 0.1 if full else 0.05
    cfg = LocalSGDConfig(gossip=GossipConfig(topology=topology_from_name("ring", world)), optimizer=opt(base_lr), h=1)
    data = None
    if data_dir is not None:
        from consensusml_tpu_torch.data.files import load_cifar10

        data = load_cifar10(data_dir)  # real CIFAR-10 is 32 px at either scale
    data = data or SyntheticClassification(n=4096 if full else 512, image_shape=(image, image, 3), noise=0.25)
    model = resnet_model(scale, norm_impl)
    if norm_impl == "flax":
        norm_path = "PyTorch batch norm (norm_impl='flax')"
    elif norm_impl == "jnp" or dev.type != "cuda":
        norm_path = f"fused BN, plain PyTorch versions (norm_impl={norm_impl!r}, no kernels)"
    else:
        norm_path = f"fused BN, hand-written CUDA kernels (norm_impl={norm_impl!r})"
    return RunBundle(
        name="cifar_resnet50",
        world_size=world,
        cfg=cfg,
        model=model,
        loss_fn=resnet_loss_fn(model),
        batches=lambda rounds, seed, start=0: round_batches(data, world, cfg.h, batch, rounds, seed, start=start),
        draw_init=lambda seed, ranks: resnet_init_params(model, seed, world, ranks),
        convert=resnet_from_flax,
        codec_path="none (exact gossip)",
        norm_path=norm_path,
        description="ResNet-50 (CIFAR stem), 8-worker ring consensus",
        eval_fn=classification_eval_fn(model, train_kwarg=True),
        eval_batches=lambda n_batches, seed: cls_eval_batches(data, batch, n_batches, seed),
        optimizer_factory=opt,
        base_lr=base_lr,
        data_source=_source(data),
    )


def _gpt2_topk(scale: str, world: int | None, codec: str | None, gamma: float | None,
               codec_warmup: int | None, norm_impl: str, dev: torch.device, data_dir: str | None = None) -> RunBundle:
    from consensusml_tpu_torch.compress import (
        PallasFp8Compressor,
        PallasInt4Compressor,
        PallasInt8Compressor,
        topk_int4_compressor,
        topk_int8_compressor,
    )
    from consensusml_tpu_torch.consensus import GossipConfig
    from consensusml_tpu_torch.data import SyntheticLM, lm_eval_batches
    from consensusml_tpu_torch.models.convert import gpt2_from_flax
    from consensusml_tpu_torch.models.gpt2 import gpt2_loss_fn
    from consensusml_tpu_torch.topology import topology_from_name
    from consensusml_tpu_torch.train.evaluate import causal_lm_eval_fn
    from consensusml_tpu_torch.train.local_sgd import LocalSGDConfig
    from consensusml_tpu_torch.train.optim import adam

    codec = codec or "topk_int8"
    if codec not in CODECS:
        raise NotImplementedError(f"codec {codec!r} is not ported yet (one of {CODECS})")
    full = scale == "full"
    mcfg = gpt2_config(scale, norm_impl=norm_impl)  # GPT2Config refuses an unknown norm_impl
    world = world or (8 if full else 4)
    batch, seq = (8, 1024) if full else (8, 16)
    chunk = 512 if full else 128
    if codec in ("topk_int8", "topk_int4"):
        # train.py --codec topk_int8|topk_int4 reads the config's chunk and
        # k (ratio 0.1 at smoke scale) and changes only the value quantizer
        make = topk_int8_compressor if codec == "topk_int8" else topk_int4_compressor
        comp = make(chunk=512, k=8, impl="auto") if full else make(ratio=0.1, chunk=128, impl="auto")
        codec_name = f"{codec}/{chunk} k={comp.inner.k_per_chunk}"
    else:
        # train.py --codec int8|int4|fp8: the kernel tiling's lane multiple
        chunk = -(-chunk // 128) * 128
        make = {"int8": PallasInt8Compressor, "int4": PallasInt4Compressor, "fp8": PallasFp8Compressor}[codec]
        comp, codec_name = make(chunk=chunk), f"{codec}/{chunk}"
    gossip = GossipConfig(
        topology=topology_from_name("ring", world),
        compressor=comp,
        gamma=(0.1 if full else 0.5) if gamma is None else gamma,
        codec_warmup_rounds=(50 if full else 0) if codec_warmup is None else codec_warmup,
        codec_refresh_every=50 if full else 0,
    )
    opt, base_lr = adam, 1e-4 if full else 3e-3
    cfg = LocalSGDConfig(gossip=gossip, optimizer=opt(base_lr), h=2)
    data = _file_tokens(data_dir, seq, mcfg.vocab_size) or SyntheticLM(vocab_size=mcfg.vocab_size, seq_len=seq)
    model = GPT2LM(mcfg, device="meta")
    on_card = dev.type == "cuda"
    path = "hand-written CUDA kernels" if on_card else "plain PyTorch versions (no card)"
    if norm_impl == "flax":
        norm_path = "flax LayerNorm"
    else:
        kernels_run = on_card and norm_impl == "pallas"
        norm_path = "fused LN, " + ("hand-written CUDA kernels" if kernels_run else "plain PyTorch versions")
    norm_path += f" (norm_impl={norm_impl!r})"
    return RunBundle(
        name="gpt2_topk",
        world_size=world,
        cfg=cfg,
        model=model,
        loss_fn=gpt2_loss_fn(model),
        batches=_lm_batches(data, world, cfg.h, batch),
        draw_init=lambda seed, ranks: gpt2_init_params(mcfg, seed, world, ranks),
        convert=lambda init: (gpt2_from_flax(init), {}),
        codec_path=f"{codec_name} -> {path}",
        norm_path=norm_path,
        description=f"GPT-2 pretrain with {codec} compressed gossip (CHOCO)",
        eval_fn=causal_lm_eval_fn(model),
        eval_batches=lambda n_batches, seed: lm_eval_batches(data, batch, n_batches, seed),
        optimizer_factory=opt,
        base_lr=base_lr,
        data_source=_source(data),
    )
