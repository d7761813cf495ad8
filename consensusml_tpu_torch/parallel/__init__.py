"""Parallelism beyond gossip-DP (counterpart of ``consensusml_tpu.parallel``):
sequence parallelism (ring attention, dense and on the flash kernels'
q/k offsets, and Ulysses all-to-all attention), GPipe pipelining, and the
regex rules that shard a model over tensor-parallel ranks (:mod:`.sharding`,
run by :mod:`.tensor`). A mesh axis is a process group over the port's
transport (:class:`.axis.Axis`)."""

from consensusml_tpu_torch.parallel.axis import Axis, make_axes  # noqa: F401
from consensusml_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    pipeline_last_stage_mean,
)
from consensusml_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    ring_flash_attention,
)
from consensusml_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardingRules,
    gpt2_tp_rules,
    llama_tp_rules,
    moe_ep_rules,
    pipeline_pp_rules,
    spec_for_path,
)
from consensusml_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
