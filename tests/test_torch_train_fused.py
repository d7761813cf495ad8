"""``gpt2_topk`` smoke training on the fused one-pass wire (``--codec
int8``, ``int4`` and ``fp8``) against the JAX package's Pallas codecs in
interpret mode, three rounds from the same initial parameters and
batches. Tolerances and their readings: ``tests/test_torch_train.py``'s
module docstring, whose helpers these tests use.
"""

import pytest

from test_torch_train import _assert_curves_match, _port_run, _reference_run


def test_smoke_training_curves_match_reference():
    init, want, fused = _reference_run(seed=0)
    assert fused
    bundle, _state, got = _port_run(init, "int8")
    assert bundle.cfg.engine().fused_wire_active
    _assert_curves_match(got, want)


@pytest.mark.parametrize("codec", ["int4", "fp8"])
def test_smoke_training_curves_fused_formats_match_reference(codec):
    """``--codec int4`` and ``--codec fp8``: the fused wire in its other
    two formats, at the int8 fused wire's tolerances."""
    init, want, fused = _reference_run(seed=0, codec=codec)
    assert fused
    bundle, state, got = _port_run(init, codec)
    comp = bundle.cfg.gossip.compressor
    assert bundle.cfg.engine().fused_wire_active and comp.fused_wire() == codec and comp.chunk == 128
    assert bundle.codec_path.startswith(f"{codec}/128 -> plain PyTorch versions")
    _assert_curves_match(got, want)

