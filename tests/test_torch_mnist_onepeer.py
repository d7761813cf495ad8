"""``mnist_mlp`` smoke's 120-round curves on the time-varying one-peer
exponential graph against the JAX package: the onepeer-exp case of
``tests/test_torch_mnist.py::test_mnist_curves_match_reference`` (its
module docstring gives the tolerances), in a file of its own so that the
suite's workers can run it beside the ring's.
"""

import pytest
import torch

from test_torch_mnist import assert_curves


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec,rounds", [("onepeer-exp", 120)])
def test_mnist_curves_match_reference(spec, rounds):
    assert_curves(spec, rounds)
