"""``gpt2_topk`` smoke training on the config's own codec (chunked top-k
+ int8 on the two-step wire; in f32 and at the config's bf16) and on
top-k + int4 with the fused LayerNorm (``--codec topk_int4 --norm-impl
pallas``), against the JAX package, three rounds from the same initial
parameters and batches. Tolerances and their readings:
``tests/test_torch_train.py``'s module docstring, whose helpers these
tests use.
"""

from test_torch_train import _assert_curves_match, _port_run, _reference_run


def test_smoke_training_curves_default_codec_match_reference():
    """``configs.build`` with no codec is the config's own, as the
    reference's ``train.py`` without ``--codec`` (model in f32, see the
    module docstring)."""
    init, want, fused = _reference_run(seed=0, codec=None, f32=True)
    assert not fused
    bundle, state, got = _port_run(init, None, f32=True)
    comp = bundle.cfg.gossip.compressor
    assert not bundle.cfg.engine().fused_wire_active and len(state.gossip.xhat) == 1
    assert (comp.inner.chunk, comp.inner.k_per_chunk, comp.outer.chunk) == (128, 13, 128)
    _assert_curves_match(got, want)


def test_smoke_training_curves_default_codec_bf16_match_reference():
    """The config's own codec at the config's precision (bf16 compute):
    round 0 at the tolerances of the other curves, later rounds at the
    limits set from the readings in the module docstring."""
    init, want, fused = _reference_run(seed=0, codec=None)
    assert not fused
    _bundle, _state, got = _port_run(init, None)
    _assert_curves_match(got, want, later=(1e-2, 1e-3))


def test_smoke_training_curves_topk_int4_fused_ln_match_reference():
    """The slice's path (``--codec topk_int4 --norm-impl pallas``) in f32
    against the reference's kernel path: top-k + int4 on the two-step
    wire, every LayerNorm the fused one."""
    init, want, fused = _reference_run(seed=0, codec="topk_int4", f32=True, norm_impl="interpret")
    assert not fused
    bundle, state, got = _port_run(init, "topk_int4", f32=True, norm_impl="pallas")
    comp = bundle.cfg.gossip.compressor
    assert not bundle.cfg.engine().fused_wire_active and len(state.gossip.xhat) == 1
    assert (comp.inner.chunk, comp.inner.k_per_chunk, comp.outer.chunk, comp.outer.fused_wire()) == (
        128, 13, 128, "int4")
    assert "fused LN" in bundle.norm_path
    _assert_curves_match(got, want)

