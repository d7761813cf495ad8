"""Int8 codec and fused CHOCO encode of the port against the JAX package,
BIT FOR BIT (zero tolerance): the payload (int8 data, f32 scales) and the
tracked ``xhat' = xhat + q * scale``. "The JAX package" is the program
XLA compiles from it: the scale is ``absmax * f32(1/127)`` and ``xhat'``
one fused multiply-add (see ``compress/reference.py:quantize_rows`` and
``fma_f32`` in the port). The JAX side runs its Pallas
kernels in interpret mode, as tests/test_fused_wire.py does. Inputs are
numpy-seeded and include an all-zero chunk, a chunk of mixed +0/-0, a
zero delta on a -0 ``xhat`` (``-0 + 0`` must give +0 in both), values on
the round-half boundaries of the quantizer, and ragged tensor sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.compress import Int8Compressor as JaxInt8
from consensusml_tpu.compress import PallasInt8Compressor as JaxPallasInt8
from consensusml_tpu.compress.kernels import FusedBucketCodec as JaxFusedCodec
from consensusml_tpu.compress.kernels import fused_pack_quantize as jax_fused_pack_quantize
from consensusml_tpu_torch.compress import (
    Int8Compressor,
    PallasInt8Compressor,
    fused_bucket_codec,
    fused_pack_quantize,
)
from consensusml_tpu_torch.compress.kernels import FusedBucketCodec


def _rows(seed, rows, chunk):
    """(x, xhat) rows with the hazards of the quantizer in them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, chunk)).astype(np.float32)
    xhat = (x + rng.normal(scale=0.1, size=(rows, chunk))).astype(np.float32)
    x[0] = xhat[0]  # zero delta: scale 0, q 0, xhat' = xhat
    x[1] = 0.0
    xhat[1] = np.where(np.arange(chunk) % 2, -0.0, 0.0).astype(np.float32)  # +0/-0 mix
    # exact half-integers after scaling: row absmax 127 makes scale 1
    x[2] = xhat[2] + np.round(rng.uniform(-126, 126, chunk)).astype(np.float32) + 0.5
    x[2, 0] = xhat[2, 0] + 127.0
    x[3] *= np.float32(1e-30)  # tiny deltas (subnormal scales)
    xhat[3] = 0.0
    return x, xhat


def _bits(a):
    return np.asarray(a).view(np.uint8 if np.asarray(a).dtype.itemsize == 1 else np.uint32)


@pytest.mark.parametrize("chunk", [128, 512])
def test_fused_encode_bit_equal_to_reference(chunk):
    x, xhat = _rows(chunk, 40, chunk)
    wq, ws, wh = jax_fused_pack_quantize(jnp.asarray(x), jnp.asarray(xhat), fmt="int8", interpret=True)
    before = fused_pack_quantize.launches
    q, s, h = fused_pack_quantize(torch.from_numpy(x), torch.from_numpy(xhat))
    assert fused_pack_quantize.launches == before  # CPU tensors never launch
    assert q.dtype == torch.int8 and s.shape == (40,) and h.shape == (40, chunk)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(ws))
    np.testing.assert_array_equal(_bits(h.numpy()), _bits(wh))
    assert s[0] == 0 and s[1] == 0 and s[2] == 1.0
    assert not np.signbit(h[1].numpy()).any()  # -0 + 0 = +0


def test_fused_bucket_codec_encode_matches_reference_stacked():
    """A stacked (W, total) bucket: the worker axis only adds chunk rows."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8 * 128)).astype(np.float32)
    xhat = (0.5 * x + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
    xhat[1, :128] = x[1, :128]
    want_p, want_h = JaxFusedCodec(fmt="int8", chunk=128, impl="interpret").encode(
        jnp.asarray(x), jnp.asarray(xhat)
    )
    got_p, got_h = FusedBucketCodec(fmt="int8", chunk=128).encode(
        torch.from_numpy(x), torch.from_numpy(xhat)
    )
    assert got_p.data.shape == (4, 1024) and got_p.scales.shape == (4, 8)
    np.testing.assert_array_equal(got_p.data.numpy(), np.asarray(want_p.data))
    np.testing.assert_array_equal(_bits(got_p.scales.numpy()), _bits(want_p.scales))
    np.testing.assert_array_equal(_bits(got_h.numpy()), _bits(want_h))
    dec = FusedBucketCodec(fmt="int8", chunk=128).decode(got_p)
    want_dec = JaxFusedCodec(fmt="int8", chunk=128, impl="jnp").decode(want_p)
    np.testing.assert_array_equal(_bits(dec.numpy()), _bits(want_dec))


@pytest.mark.parametrize("n", [5, 128, 300, 1000, 4096])
@pytest.mark.parametrize("chunk", [128, 512])
def test_pallas_int8_payload_bit_equal(n, chunk):
    rng = np.random.default_rng(n + chunk)
    x = rng.normal(size=(n,)).astype(np.float32)
    x[: min(n, 3)] = 0.0
    want = JaxPallasInt8(chunk=chunk, impl="interpret").compress(jnp.asarray(x))
    got = PallasInt8Compressor(chunk=chunk).compress(torch.from_numpy(x))
    assert got.chunk == want.chunk
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(_bits(got.scales.numpy()), _bits(want.scales))
    back = PallasInt8Compressor(chunk=chunk).decompress(got)
    want_back = JaxPallasInt8(chunk=chunk, impl="interpret").decompress(want)
    np.testing.assert_array_equal(_bits(back.numpy()), _bits(want_back))
    # the kernel path's layout (chunk never below 128), not the reference's
    # off-TPU "auto" -> jnp one, which clamps the chunk to the tensor
    assert PallasInt8Compressor(chunk=chunk).wire_bytes((n,)) == JaxPallasInt8(
        chunk=chunk, impl="interpret"
    ).wire_bytes((n,), jnp.float32)


@pytest.mark.parametrize("shape", [(7,), (3, 100), (256, 3)])
def test_reference_int8_codec_bit_equal(shape):
    """Against the reference codec as the engine runs it, under jit: XLA
    compiles its ``absmax / 127`` into a product with the f32 reciprocal
    (eagerly it is a true quotient, one ulp off on some rows)."""
    x = np.random.default_rng(1).normal(size=(*shape[:-1], shape[-1] * 40)).astype(np.float32)
    want = jax.jit(JaxInt8(chunk=256).compress)(jnp.asarray(x))
    got = Int8Compressor(chunk=256).compress(torch.from_numpy(x))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(_bits(got.scales.numpy()), _bits(want.scales))
    assert Int8Compressor(chunk=256).wire_bytes(shape) == JaxInt8(chunk=256).wire_bytes(shape, jnp.float32)


def test_non_finite_delta_propagates_to_scale_and_xhat():
    """jnp.max propagates NaN (fmaxf would drop it): a NaN in a row makes
    that row's scale and every xhat' of the row NaN, in both."""
    x, xhat = _rows(9, 8, 128)
    x[5, 17] = np.nan
    wq, ws, wh = jax_fused_pack_quantize(jnp.asarray(x), jnp.asarray(xhat), fmt="int8", interpret=True)
    q, s, h = fused_pack_quantize(torch.from_numpy(x), torch.from_numpy(xhat))
    assert np.isnan(np.asarray(ws)[5]) and torch.isnan(s[5])
    assert np.isnan(np.asarray(wh)[5]).all() and torch.isnan(h[5]).all()
    ok = np.arange(8) != 5
    np.testing.assert_array_equal(_bits(h.numpy()[ok]), _bits(np.asarray(wh)[ok]))


def test_fused_codec_selection_and_refusals():
    codec = fused_bucket_codec(PallasInt8Compressor(chunk=512))
    assert codec is not None and codec.fmt == "int8" and codec.chunk == 512
    # the reference codec's chunk need not be a multiple of 128 (plain ops on the CPU)
    assert fused_bucket_codec(Int8Compressor(chunk=100)).chunk == 100
    with pytest.raises(NotImplementedError):
        fused_pack_quantize(torch.zeros(2, 128), torch.zeros(2, 128), fmt="int4")
    with pytest.raises(NotImplementedError):
        FusedBucketCodec(fmt="fp8", chunk=128)
    with pytest.raises(ValueError):
        PallasInt8Compressor(chunk=100)


def test_decode_accumulate_bit_equal_to_reference():
    """The receive half of the fused wire (plain ops in this slice):
    ``s + sum_j w_j * dec(q_j)``, self first, ``s`` added last, against the
    reference's jnp impl under jit, as its engine runs it (called eagerly,
    jnp divides by 127 where the compiled program multiplies by f32(1/127),
    and the payloads differ)."""
    rng = np.random.default_rng(11)
    s = rng.normal(size=(6 * 128,)).astype(np.float32)
    srcs = [(rng.normal(size=(6 * 128,)).astype(np.float32), np.zeros(6 * 128, np.float32)) for _ in range(3)]
    weights = (1 / 3, 1 / 3, 1 / 3)
    jcodec = JaxFusedCodec(fmt="int8", chunk=128, impl="jnp")
    jp = [jax.jit(jcodec.encode)(jnp.asarray(x), jnp.asarray(h))[0] for x, h in srcs]
    want = jax.jit(lambda s_, ps: jcodec.decode_accumulate(s_, ps, weights))(jnp.asarray(s), jp)
    codec = FusedBucketCodec(fmt="int8", chunk=128)
    tp = [codec.encode(torch.from_numpy(x), torch.from_numpy(h))[0] for x, h in srcs]
    got = codec.decode_accumulate(torch.from_numpy(s), tp, weights)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_compress_tree_round_trip_matches_reference():
    rng = np.random.default_rng(12)
    tree = {"b": rng.normal(size=(300,)).astype(np.float32), "a": {"w": rng.normal(size=(5, 60)).astype(np.float32)}}
    jcomp = JaxPallasInt8(chunk=128, impl="interpret")
    want = jcomp.decompress_tree(jcomp.compress_tree(jax.tree.map(jnp.asarray, tree)), tree)
    comp = PallasInt8Compressor(chunk=128)
    ttree = {"b": torch.from_numpy(tree["b"]), "a": {"w": torch.from_numpy(tree["a"]["w"])}}
    got = comp.decompress_tree(comp.compress_tree(ttree), ttree)
    np.testing.assert_array_equal(_bits(got["b"].numpy()), _bits(want["b"]))
    np.testing.assert_array_equal(_bits(got["a"]["w"].numpy()), _bits(want["a"]["w"]))
