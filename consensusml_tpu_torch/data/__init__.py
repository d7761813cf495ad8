"""Input data (counterpart of ``consensusml_tpu.data``): the procedural
and file-backed round-batch streams, the native ring's iterators and the
overlapped device feed."""

from consensusml_tpu_torch.data.synthetic import (
    SyntheticClassification,
    SyntheticLM,
    cls_eval_batches,
    lm_eval_batches,
    lm_round_batches,
    mlm_corrupt,
    round_batches,
)
from consensusml_tpu_torch.data.native_pipeline import (
    native_cls_feed,
    native_file_round_batches,
    native_file_token_batches,
    native_lm_round_batches,
    native_round_batches,
    plan_ring,
)
from consensusml_tpu_torch.data.prefetch import DevicePrefetcher, FeedItem, prefetch_to_device
from consensusml_tpu_torch.data.files import (
    FileClassification,
    TokenFileDataset,
    load_cifar10,
    load_mnist,
    load_tokens,
    read_idx,
    token_round_batches,
)

__all__ = [
    "SyntheticClassification", "round_batches", "SyntheticLM", "lm_round_batches", "cls_eval_batches",
    "lm_eval_batches", "mlm_corrupt", "native_cls_feed", "native_file_round_batches", "native_file_token_batches",
    "native_lm_round_batches", "native_round_batches", "plan_ring", "DevicePrefetcher", "FeedItem",
    "prefetch_to_device", "FileClassification", "TokenFileDataset", "load_cifar10", "load_mnist", "load_tokens",
    "read_idx", "token_round_batches",
]
