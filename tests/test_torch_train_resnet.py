"""``cifar_resnet50`` smoke training with PyTorch's batch norm
(``norm_impl="flax"``) against the JAX package's, three rounds in f32 from
the same initial variables and batches: the flax case of
``tests/test_torch_train.py::test_resnet_smoke_training_curves_match_reference``
(its docstring gives the tolerances), in a file of its own so that the
suite's workers can run the two cases side by side.
"""

import pytest

from test_torch_train import resnet_curves


@pytest.mark.parametrize("norm_impl", ["flax"])
def test_resnet_smoke_training_curves_match_reference(norm_impl):
    resnet_curves(norm_impl)
