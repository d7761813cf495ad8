"""A reference ``cifar_resnet50`` checkpoint converted by the port: BN
statistics, SGD's trace, the clip's chain, the cosine schedule's count and
SlowMo's ``x``/``u``, every leaf of the reference's state filled with
numpy-seeded values (counts drawn as int32), saved and restored by the
reference and converted bit for bit (``tests/test_torch_ref_checkpoint.py``
continues a converted run)."""

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_ref_checkpoint import convert_reference_checkpoint


def _filled(state):
    """Every leaf of a reference state drawn anew (the rng kept)."""
    rng = np.random.default_rng(7)
    draw = lambda x: jnp.asarray(  # noqa: E731
        rng.integers(0, 1000, x.shape).astype(x.dtype) if jnp.issubdtype(x.dtype, jnp.integer)
        else rng.normal(size=x.shape).astype(x.dtype))
    return state._replace(**{f: jax.tree.map(draw, getattr(state, f)) for f in state._fields if f != "rng"})


def test_resnet_reference_checkpoint_converts_bit_for_bit(tmp_path):
    _, pstate, _ = convert_reference_checkpoint(tmp_path, "cifar_resnet50", _filled)
    assert pstate.model_state["batch_stats"] and pstate.opt_state.inner.trace
