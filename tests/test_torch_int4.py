"""The int4 codec of the port against the JAX package, BIT FOR BIT (zero
tolerance; floats compared as their bit patterns, packed bytes as uint8).

The JAX side runs its Pallas kernels in interpret mode
(``quantize_int4(interpret=True)``, ``PallasInt4Compressor(impl=
"interpret")``, the TPU kernel path) and its reference codecs jitted, as
its engine runs them; the port's side runs the kernels' plain versions
(CPU tensors never launch). Inputs are numpy-seeded and carry the
hazards of the int4 quantizer:

- a zero row and a row of +0/-0 (scale 0, every code 0, decoding to +0);
- ties on the round-half points at scale 1 (3.5 -> 4, -3.5 -> -4, 0.5 ->
  0, 1.5 -> 2: half to even);
- rows at +-absmax (codes 7 and -7, which packs as nibble 0x9);
- a row holding a NaN (scale NaN, every byte 0: XLA converts NaN to 0)
  and one holding an inf (scale inf, inverse 0, every code 0);
- tiny normal values; the subnormal rows have a test of their own (the
  compiled reference flushes f32 subnormals: reads them as zeros and
  writes zeros for them).

The scale is ``absmax * f32(1/7)``, the product XLA compiles the
reference's ``absmax / 7`` into: the eager reference divides, and one
test pins that the two differ, so the port's choice stays deliberate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.compress import PallasInt4Compressor as JaxPallasInt4
from consensusml_tpu.compress import kernels as jk
from consensusml_tpu.compress.reference import Int4Compressor as JaxInt4
from consensusml_tpu.compress.reference import topk_int4_compressor as jax_topk_int4
from consensusml_tpu_torch.compress import (
    ComposedCompressor,
    Int4Compressor,
    Int4Payload,
    PallasInt4Compressor,
    TopKCompressor,
    dequantize_int4,
    fused_bucket_codec,
    quantize_int4,
    topk_int4_compressor,
)
from consensusml_tpu_torch.compress.kernels import dequantize_int4_plain, quantize_int4_plain
from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
from consensusml_tpu_torch.topology import RingTopology


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _rows(seed, rows, chunk):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, chunk)) * 3).astype(np.float32)
    col = np.arange(chunk)
    x[0] = 0.0
    x[1] = np.where(col % 2, -0.0, 0.0)
    # scale 1 (absmax 7): the round-half points of every code, both signs
    x[2] = rng.integers(-7, 7, chunk) + 0.5
    x[2, :5] = [7.0, 3.5, -3.5, 0.5, 1.5]
    x[3] = np.where(col % 3 == 0, 2.0, -2.0)  # +-absmax: codes 7 and -7
    x[4, 5] = np.nan
    x[5, 9] = np.inf
    x[6] *= np.float32(1e-30)
    return x


@pytest.mark.parametrize("rows,chunk", [(40, 128), (7, 256), (33, 512), (9, 1024)])
def test_quantize_dequantize_int4_bit_equal(rows, chunk):
    x = _rows(rows + chunk, rows, chunk)
    wp, ws = jk.quantize_int4(jnp.asarray(x), interpret=True)
    before = (quantize_int4.launches, dequantize_int4.launches)
    p, s = quantize_int4(torch.from_numpy(x))
    assert p.dtype == torch.uint8 and p.shape == (rows, chunk // 2) and s.shape == (rows,)
    _eq(p, wp, "packed")
    _eq(s, ws, "scales")
    d = dequantize_int4(p, s)
    _eq(d, jk.dequantize_int4(wp, ws, interpret=True), "dequantize")
    assert (quantize_int4.launches, dequantize_int4.launches) == before  # CPU tensors never launch
    # the hazards, read off the port's payload
    assert s[0] == 0 and s[2] == 1.0 and torch.isnan(s[4]) and torch.isinf(s[5])
    assert not p[[0, 1, 4, 5]].any()  # zero, +-0, NaN and inf rows: every code 0
    assert not torch.signbit(d[:2]).any()  # -0.0 decodes to +0.0
    assert d[2, :5].tolist() == [7.0, 4.0, -4.0, 0.0, 2.0]  # half to even
    assert set(d[3].tolist()) == {2.0, -2.0}


def test_int4_nibble_layout():
    """Byte j holds element j in its low nibble and element j + C/2 in its
    high nibble, two's complement: -7 is 0x9."""
    x = np.zeros((1, 128), np.float32)
    x[0, 0], x[0, 64], x[0, 1], x[0, 65] = 7.0, -7.0, -1.0, 3.0
    p, s = quantize_int4(torch.from_numpy(x))
    assert p[0, 0] == 0x97 and p[0, 1] == 0x3F and not p[0, 2:].any()
    wp, _ = jk.quantize_int4(jnp.asarray(x), interpret=True)
    _eq(p, wp)
    assert dequantize_int4_plain(p, s)[0, [0, 64, 1, 65]].tolist() == [7.0, -7.0, -1.0, 3.0]


def test_scale_is_the_compiled_product_not_the_eager_quotient():
    """The eager reference divides ``absmax / 7``; jitted (and in its
    kernel) XLA multiplies by f32(1/7). The two differ in the last bit on
    some rows; the port matches the kernel path on every row."""
    x = np.random.default_rng(16).normal(size=(16, 512)).astype(np.float32)
    _, kernel_scales = jk.quantize_int4(jnp.asarray(x), interpret=True)
    eager = JaxInt4(chunk=512).compress(jnp.asarray(x.reshape(-1)))
    jitted = jax.jit(JaxInt4(chunk=512).compress)(jnp.asarray(x.reshape(-1)))
    kernel_scales = np.asarray(kernel_scales)
    assert (np.asarray(eager.scales) != kernel_scales).sum() > 0
    _eq(jitted.scales, kernel_scales, "jitted")
    _, s = quantize_int4_plain(torch.from_numpy(x))
    _eq(s, kernel_scales, "port")
    _eq(Int4Compressor(chunk=512).compress(torch.from_numpy(x.reshape(-1))).scales, kernel_scales, "port codec")


@pytest.mark.parametrize("shape", [(5,), (300,), (4096,), (3, 70), (7, 300)])
def test_pallas_int4_codec_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[:2] = 0.0
    tc, jc = PallasInt4Compressor(chunk=512), JaxPallasInt4(chunk=512, impl="interpret")
    tp, jp = tc.compress(torch.from_numpy(x)), jc.compress(jnp.asarray(x))
    assert isinstance(tp, Int4Payload) and tp.chunk == jp.chunk
    _eq(tp.data, jp.data, "data")
    _eq(tp.scales, jp.scales, "scales")
    _eq(tc.decompress(tp), jc.decompress(jp), "decompress")
    # the kernel path's layout (chunk never below 128)
    assert tc.wire_bytes(shape) == jc.wire_bytes(shape, jnp.float32)


@pytest.mark.parametrize("chunk,n", [(256, 1000), (7, 100), (9, 4), (512, 5)])
def test_reference_int4_codec_bit_equal(chunk, n):
    """The semantics oracle against the jitted reference: the chunk clamped
    to the tensor, then made even (an odd one gains a padding element)."""
    x = np.random.default_rng(chunk + n).normal(size=(n,)).astype(np.float32)
    tc, jc = Int4Compressor(chunk=chunk), JaxInt4(chunk=chunk)
    assert tc.bucket_alignment() == jc.bucket_alignment() == chunk + chunk % 2
    tp, jp = tc.compress(torch.from_numpy(x)), jax.jit(jc.compress)(jnp.asarray(x))
    assert tp.chunk == jp.chunk and tp.chunk % 2 == 0
    _eq(tp.data, jp.data, "data")
    _eq(tp.scales, jp.scales, "scales")
    _eq(tc.decompress(tp), jax.jit(jc.decompress)(jp), "decompress")
    assert tc.wire_bytes((n,)) == jc.wire_bytes((n,), jnp.float32)


@pytest.mark.parametrize("chunk,k", [(512, 8), (128, 13), (128, 100)])
@pytest.mark.parametrize("shape", [(3, 70), (2048,), (7, 300)])
def test_topk_int4_codec_bit_equal(shape, chunk, k):
    """The slice's codec, port ``impl="auto"`` on the CPU against JAX
    ``impl="interpret"``: packed values, scales and uint16 indices, then
    both decodes."""
    rng = np.random.default_rng(chunk + k + shape[0])
    x = rng.normal(size=shape).astype(np.float32)
    acc = rng.normal(size=shape).astype(np.float32)
    tc, jc = topk_int4_compressor(chunk=chunk, k=k, impl="auto"), jax_topk_int4(chunk=chunk, k=k, impl="interpret")
    assert isinstance(tc, ComposedCompressor) and tc.bucket_alignment() == chunk
    assert tc.outer.chunk == max(chunk, 128) and tc.fused_wire() is None
    tp, jp = tc.compress(torch.from_numpy(x)), jc.compress(jnp.asarray(x))
    assert isinstance(tp.values, Int4Payload)
    _eq(tp.values.data, jp.values.data, "int4 values")
    _eq(tp.values.scales, jp.values.scales, "scales")
    _eq(tp.indices.numpy().astype(np.uint16), jp.indices, "uint16 indices")
    _eq(tc.decompress(tp), jc.decompress(jp), "decompress")
    _eq(tc.decompress_accumulate(tp, torch.from_numpy(acc), 1 / 3),
        jax.jit(lambda p, a: jc.decompress_accumulate(p, a, 1 / 3))(jp, jnp.asarray(acc)), "accumulate")


@pytest.mark.parametrize("shape", [(300,), (7, 90)])
def test_reference_topk_int4_bit_equal(shape):
    """``impl="reference"``: global top-k + the int4 oracle, against the
    JAX package's jitted."""
    rng = np.random.default_rng(len(shape) + 10)
    x = rng.normal(size=shape).astype(np.float32)
    tc = topk_int4_compressor(ratio=0.1, chunk=16, impl="reference")
    jc = jax_topk_int4(ratio=0.1, chunk=16, impl="reference")
    assert isinstance(tc.inner, TopKCompressor) and tc.bucket_alignment() is None
    tp, jp = tc.compress(torch.from_numpy(x)), jax.jit(jc.compress)(jnp.asarray(x))
    _eq(tp.indices, jp.indices, "indices")
    _eq(tp.values.data, jp.values.data, "int4 values")
    _eq(tp.values.scales, jp.values.scales, "scales")
    _eq(tc.decompress(tp), jax.jit(jc.decompress)(jp), "decompress")
    assert tc.wire_bytes(shape) == jc.wire_bytes(shape, jnp.float32)


def test_topk_int4_wire_rates_and_stacked_compress():
    """Bytes per chunk the bucket planner reads (the kernel path's layout:
    the value vector's int4 chunk is never below 128), and
    ``compress(x, stacked=True)`` equal to each worker compressed alone
    (the reference's vmap)."""
    full = topk_int4_compressor(chunk=512, k=8, impl="auto")
    smoke = topk_int4_compressor(ratio=0.1, chunk=128, impl="auto")
    assert full.wire_bytes((512,)) == 84  # 64 packed + 4 scale + 8 x 2 index bytes
    assert smoke.inner.k_per_chunk == 13 and smoke.wire_bytes((128,)) == 94
    assert full.wire_bytes((512,)) == jax_topk_int4(chunk=512, k=8, impl="interpret").wire_bytes((512,), jnp.float32)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(4, 3 * 128)).astype(np.float32))
    comp = topk_int4_compressor(chunk=128, k=8, impl="auto")
    p = comp.compress(x, stacked=True)
    assert p.values.data.shape == (4, 64) and p.values.scales.shape == (4, 1) and p.indices.shape == (4, 3, 8)
    dec = comp.decompress(p)
    for w in range(4):
        pw = comp.compress(x[w])
        _eq(p.values.data[w], pw.values.data)
        _eq(p.values.scales[w], pw.values.scales)
        _eq(dec[w], comp.decompress(pw))


def test_int4_fused_wire_is_refused_and_topk_int4_takes_the_two_step_wire():
    """``PallasInt4Compressor`` tags the int4 fused wire, which an engine
    now takes (the reference's bare ``--codec int4``; its encode was
    refused until the int4 format was ported); the top-k codec has no fused
    wire and runs the two-step one."""
    topo = RingTopology(4)
    codec = fused_bucket_codec(PallasInt4Compressor(chunk=128))
    assert (codec.fmt, codec.chunk, codec.wire_width) == ("int4", 128, 64)
    assert ConsensusEngine(GossipConfig(topology=topo, compressor=PallasInt4Compressor(chunk=128))).fused_wire_active
    GossipConfig(topology=topo, compressor=PallasInt4Compressor(chunk=128), fused_wire=True)
    eng = ConsensusEngine(GossipConfig(topology=topo, compressor=topk_int4_compressor(chunk=128, k=8, impl="auto")))
    assert not eng.fused_wire_active
    with pytest.raises(ValueError):
        PallasInt4Compressor(chunk=100)
    with pytest.raises(ValueError):
        quantize_int4(torch.zeros(4, 127))
    with pytest.raises(ValueError):
        topk_int4_compressor(chunk=128, impl="interpret")


def test_subnormal_rows_bit_equal_and_the_unflushed_math_is_not():
    """Rows that meet f32 subnormals: all subnormal (scale 0, codes 0),
    an absmax whose scale would be subnormal (scale 0), and subnormal
    elements beside a tiny normal absmax (read as zeros). The port's int4
    quantizer and codec equal the reference's (its compiled program
    flushes subnormals); the same math with subnormals kept, PyTorch's
    default and the port before it flushed, does not."""
    f32_min = np.float32(2.0**-126)
    sign = np.where(np.arange(128) % 2, 1, -1).astype(np.float32)
    x = np.stack([np.float32(1e-39) * sign, np.float32(5e-38) * sign, np.float32(0.9) * f32_min * sign])
    x[2, 0] = np.float32(7 * 1.5) * f32_min
    wp, ws = jk.quantize_int4(jnp.asarray(x), interpret=True)
    p, s = quantize_int4(torch.from_numpy(x))
    _eq(p, wp, "packed")
    _eq(s, ws, "scales")
    assert s[0] == 0 and s[1] == 0 and s[2] > 0 and not p[:2].any()
    want = jax.jit(JaxInt4(chunk=128).compress)(jnp.asarray(x.reshape(-1)))
    got = Int4Compressor(chunk=128).compress(torch.from_numpy(x.reshape(-1)))
    _eq(got.data, want.data, "codec data")
    _eq(got.scales, want.scales, "codec scales")
    _eq(Int4Compressor(chunk=128).decompress(got), jax.jit(JaxInt4(chunk=128).decompress)(want), "decode")
    xt = torch.from_numpy(x)
    raw = xt.abs().amax(1) * torch.tensor(np.float32(1 / 7))
    inv = torch.where(raw > 0, 1 / torch.where(raw > 0, raw, 1), 0)
    r = torch.clamp(torch.round(xt * inv[:, None]), -7, 7)
    naive = torch.where(torch.isnan(r), 0, r).to(torch.int32)
    naive = ((naive[:, :64] & 0xF) | ((naive[:, 64:] & 0xF) << 4)).to(torch.uint8)
    assert (naive.numpy() != np.asarray(wp)).any() and (raw.numpy() != np.asarray(ws)).any()
