"""The top-k/int8 codec kernels and codecs of the port against the JAX
package, BIT FOR BIT (zero tolerance; floats compared as their bit
patterns, uint16 indices through numpy's uint16).

The JAX side runs its Pallas kernels in interpret mode
(``impl="interpret"``, the TPU kernel path), as tests/test_kernels.py
does; the port's side runs the kernels' plain versions (CPU tensors never
launch). Inputs are numpy-seeded and carry the hazards of each kernel:

- quantize/dequantize: zero rows, values on the quantizer's round-half
  points, tiny scales;
- top-k: equal magnitudes of opposite sign (the lower index wins), rows
  with fewer than k non-zeros, ``-0.0`` entries (the kernel's masked sum
  gives ``+0.0``), subnormals (the compiled kernel reads them as zeros);
- scatter: with and without ``acc``, weight 0.3, ``-0.0`` in ``acc``
  (it comes out ``+0.0``) and as a value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.compress import ChunkedTopKCompressor as JaxChunkedTopK
from consensusml_tpu.compress import PallasInt8Compressor as JaxPallasInt8
from consensusml_tpu.compress import kernels as jk
from consensusml_tpu.compress.reference import topk_int4_compressor as jax_topk_int4
from consensusml_tpu.compress.reference import topk_int8_compressor as jax_topk_int8
from consensusml_tpu_torch.compress import (
    ChunkedTopKCompressor,
    ComposedCompressor,
    LocalTopKPayload,
    PallasInt8Compressor,
    TopKCompressor,
    TopKPayload,
    chunk_scatter,
    chunked_topk,
    dequantize_int8,
    quantize_int8,
    topk_int4_compressor,
    topk_int8_compressor,
)
from consensusml_tpu_torch.compress.reference import topk_by_magnitude


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
    x[0] = 0.0  # zero row: scale 0, k zeros picked lowest index first
    x[1] = np.where(np.arange(chunk) % 2, -0.0, 0.0)  # +0/-0 only
    x[2] = np.round(rng.uniform(-126, 126, chunk)).astype(np.float32) + 0.5  # round-half points
    x[2, 0] = 127.0  # absmax 127: scale 1
    x[3] = 0.0
    x[3, [5, 9, 40]] = [-3.0, 3.0, -0.0]  # a tie of opposite signs, fewer non-zeros than k
    x[4] = np.where(np.arange(chunk) % 3 == 0, 2.0, -2.0)  # every magnitude equal
    # tiny but normal: selected by magnitude as any other row (the
    # subnormal rows, which the reference reads as zeros, have tests of
    # their own below)
    x[5] *= np.float32(1e-30)
    return x


def _subnormal_rows(chunk):
    """Rows where the reference's flush decides the result: (0) 1.0 at 20
    beside subnormals -3e-39, 2e-39, 1e-39 at 7, 9, 3; (1) only -1e-40 at
    50 and 5e-41 at 60; (2) a normal top beside subnormals and zeros of
    both signs, so the top-k reaches into them; (3) every element a
    subnormal of alternating sign."""
    x = np.zeros((4, chunk), np.float32)
    x[0, 20] = 1.0
    x[0, [7, 9, 3]] = [-3e-39, 2e-39, 1e-39]
    x[1, [50, 60]] = [-1e-40, 5e-41]
    x[2, [100, 2, 78]] = [-2.5, 0.75, 2.0**-126]  # the smallest normal beats a subnormal
    x[2, 1::4] = -0.0
    x[2, [0, 5, 11, 64]] = [-1e-38, 3e-39, -5e-45, 1e-39]
    x[3] = np.float32(1e-39) * np.where(np.arange(chunk) % 2, -1.0, 1.0)
    return x


@pytest.mark.parametrize("rows,chunk", [(40, 128), (7, 256), (33, 512)])
def test_quantize_dequantize_int8_bit_equal(rows, chunk):
    x = _rows(rows, rows, chunk)
    wq, ws = jk.quantize_int8(jnp.asarray(x), interpret=True)
    before = (quantize_int8.launches, dequantize_int8.launches)
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.shape == (rows,)
    _eq(q, wq, "q")
    _eq(s, ws, "scales")
    assert s[0] == 0 and s[2] == 1.0
    _eq(dequantize_int8(q, s), jk.dequantize_int8(wq, ws, interpret=True), "dequantize")
    assert (quantize_int8.launches, dequantize_int8.launches) == before  # CPU tensors never launch


@pytest.mark.parametrize("k", [1, 8, 13, 64])
@pytest.mark.parametrize("chunk", [128, 512])
def test_chunked_topk_bit_equal(k, chunk):
    x = _rows(k + chunk, 24, chunk)
    wv, wi = jk.chunked_topk(jnp.asarray(x), k, interpret=True)
    before = chunked_topk.launches
    v, i = chunked_topk(torch.from_numpy(x), k)
    assert chunked_topk.launches == before
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    _eq(i, wi, "indices")
    _eq(v, wv, "values")
    if k >= 2:
        assert i[3, :2].tolist() == [5, 9] and v[3, :2].tolist() == [-3.0, 3.0]
    if k >= 4:  # the -0.0 at 40 ties the zeros after the two winners: lower index first
        assert i[3, 2:4].tolist() == [0, 1] and not torch.signbit(v[1]).any()


@pytest.mark.parametrize("k", [1, 4, 8, 13])
@pytest.mark.parametrize("chunk", [128, 512])
def test_chunked_topk_flushes_subnormals_as_the_reference(k, chunk):
    """The reference's compiled kernel reads a subnormal |x| as zero: it
    ties with the zeros and the lower index wins, and a subnormal winner's
    value (a masked row sum) is +0.0. The plain version does the same,
    bit for bit in indices and values."""
    x = _subnormal_rows(chunk)
    wv, wi = jk.chunked_topk(jnp.asarray(x), k, interpret=True)
    v, i = chunked_topk(torch.from_numpy(x), k)
    _eq(i, wi, "indices")
    _eq(v, wv, "values")
    assert not torch.signbit(v[v == 0]).any() and not ((v != 0) & (v.abs() < 2.0**-126)).any()
    if k >= 4:  # the two probe rows
        assert i[0].tolist()[:4] == [20, 0, 1, 2] and v[0].tolist()[:4] == [1.0, 0.0, 0.0, 0.0]
        assert i[1].tolist()[:4] == [0, 1, 2, 3] and not v[1].any()
    if k >= 8:
        assert i[2].tolist()[:4] == [100, 2, 78, 0]
    # without the flush the subnormals would win over the zeros
    assert topk_by_magnitude(torch.from_numpy(x[:1]), 2)[0].tolist() == [20, 7]


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("chunk,k", [(128, 8), (512, 8)])
def test_topk_codecs_flush_subnormals_as_the_reference(codec, chunk, k):
    """Top-k + int8 and top-k + int4 on tensors of the subnormal rows (the
    port's kernel path, plain versions on the CPU, against JAX
    ``impl="interpret"``): values, scales, uint16 indices and both decodes
    bit-equal."""
    x = _subnormal_rows(chunk).reshape(-1)
    acc = np.random.default_rng(chunk).normal(size=x.shape).astype(np.float32)
    make_t, make_j = {"int8": (topk_int8_compressor, jax_topk_int8),
                      "int4": (topk_int4_compressor, jax_topk_int4)}[codec]
    tc, jc = make_t(chunk=chunk, k=k, impl="auto"), make_j(chunk=chunk, k=k, impl="interpret")
    tp, jp = tc.compress(torch.from_numpy(x)), jc.compress(jnp.asarray(x))
    _eq(tp.values.data, jp.values.data, "values")
    _eq(tp.values.scales, jp.values.scales, "scales")
    _eq(tp.indices.numpy().astype(np.uint16), jp.indices, "uint16 indices")
    assert tp.indices.numpy().astype(np.int64)[:2, :4].tolist() == [[20, 0, 1, 2], [0, 1, 2, 3]]
    _eq(tc.decompress(tp), jc.decompress(jp), "decompress")
    _eq(tc.decompress_accumulate(tp, torch.from_numpy(acc), 1 / 3),
        jax.jit(lambda p, a: jc.decompress_accumulate(p, a, 1 / 3))(jp, jnp.asarray(acc)), "accumulate")


@pytest.mark.parametrize("narrow", [True, False])
def test_chunked_topk_past_64_takes_the_references_sort_branch(narrow):
    """Past 64 winners the reference's kernel path selects by ``lax.top_k``
    (its ``impl="jnp"`` branch) on every device, which keeps subnormal
    magnitudes and a ``-0.0`` winner's sign. The port takes the same branch
    on the CPU as on the card: payload indices and values bit-equal."""
    x = _subnormal_rows(128)
    x[1, 3] = -0.0  # a -0.0 winner among row 1's zeros
    x = x.reshape(-1)
    tc = ChunkedTopKCompressor(chunk=128, k_per_chunk=65, narrow_indices=narrow)
    jc = JaxChunkedTopK(chunk=128, k_per_chunk=65, impl="jnp", narrow_indices=narrow)
    before = chunked_topk.launches
    tp, jp = tc.compress(torch.from_numpy(x)), jc.compress(jnp.asarray(x))
    assert chunked_topk.launches == before
    _check_topk_payload(tp, jp)
    idx = tp.indices.numpy().astype(np.int64).reshape(4, 65) % 128
    assert idx[0, :4].tolist() == [20, 7, 9, 3]  # the subnormals win over the zeros
    assert idx[1, :3].tolist() == [50, 60, 0]
    assert torch.signbit(tp.values.reshape(4, 65)[1, 5])  # the -0.0 at 3 is the sixth winner
    # the decode flushes the subnormal winners, as the compiled reference's
    acc = np.random.default_rng(65).normal(size=x.shape).astype(np.float32)
    _eq(tc.decompress(tp), jc.decompress(jp), "decompress")
    _eq(tc.decompress_accumulate(tp, torch.from_numpy(acc), 1 / 3),
        jax.jit(lambda p, a: jc.decompress_accumulate(p, a, 1 / 3))(jp, jnp.asarray(acc)), "accumulate")


@pytest.mark.parametrize("weight", [1.0, 0.3])
@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("chunk,k", [(128, 13), (512, 8)])
def test_chunk_scatter_bit_equal(chunk, k, with_acc, weight):
    rng = np.random.default_rng(chunk + k)
    rows = 20
    vals = rng.normal(size=(rows, k)).astype(np.float32)
    vals[0, 0] = -0.0
    idx = np.stack([rng.choice(chunk, size=k, replace=False) for _ in range(rows)]).astype(np.int32)
    acc = rng.normal(size=(rows, chunk)).astype(np.float32)
    acc[1] = -0.0  # untouched -0.0 comes out +0.0
    acc[0, idx[0, 0]] = -0.0  # -0.0 + (-0.0 value) is +0.0 too
    want = jk.chunk_scatter(jnp.asarray(vals), jnp.asarray(idx), chunk,
                            jnp.asarray(acc) if with_acc else None, weight=weight, interpret=True)
    before = chunk_scatter.launches
    got = chunk_scatter(torch.from_numpy(vals), torch.from_numpy(idx), chunk,
                        torch.from_numpy(acc) if with_acc else None, weight=weight)
    assert chunk_scatter.launches == before
    _eq(got, want, "dense")
    assert not torch.signbit(got[got == 0]).any()  # no -0.0 survives


def _codec_pair(chunk, k, narrow=True):
    return (ChunkedTopKCompressor(chunk=chunk, k_per_chunk=k, narrow_indices=narrow),
            JaxChunkedTopK(chunk=chunk, k_per_chunk=k, impl="interpret", narrow_indices=narrow))


def _check_topk_payload(got, want):
    _eq(got.values, want.values, "values")
    if isinstance(got, LocalTopKPayload):
        assert got.indices.dtype == torch.uint16 and got.chunk == want.chunk
        _eq(got.indices.numpy().astype(np.uint16), want.indices, "uint16 indices")
    else:
        _eq(got.indices, want.indices, "indices")


@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("shape", [(3, 70), (1000,), (4, 512), (5,)])
def test_chunked_topk_codec_bit_equal(shape, narrow):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    acc = rng.normal(size=shape).astype(np.float32)
    tc, jc = _codec_pair(128, 8, narrow)
    tp, jp = tc.compress(torch.from_numpy(x)), jc.compress(jnp.asarray(x))
    assert isinstance(tp, LocalTopKPayload if narrow else TopKPayload)
    _check_topk_payload(tp, jp)
    _eq(tc.decompress(tp), jc.decompress(jp), "decompress")
    _eq(tc.decompress_accumulate(tp, torch.from_numpy(acc), 0.25),
        jc.decompress_accumulate(jp, jnp.asarray(acc), 0.25), "decompress_accumulate")
    assert tc.wire_bytes(shape) == jc.wire_bytes(shape, jnp.float32)


@pytest.mark.parametrize("shape", [(5,), (300,), (4096,), (3, 70)])
def test_pallas_int8_codec_bit_equal(shape):
    x = np.random.default_rng(shape[0]).normal(size=shape).astype(np.float32)
    tc, jc = PallasInt8Compressor(chunk=512), JaxPallasInt8(chunk=512, impl="interpret")
    tp, jp = tc.compress(torch.from_numpy(x)), jc.compress(jnp.asarray(x))
    assert tp.chunk == jp.chunk
    _eq(tp.data, jp.data, "data")
    _eq(tp.scales, jp.scales, "scales")
    _eq(tc.decompress(tp), jc.decompress(jp), "decompress")


@pytest.mark.parametrize("chunk,k", [(512, 8), (128, 13), (128, 100)])
@pytest.mark.parametrize("shape", [(3, 70), (2048,), (7, 300)])
def test_topk_int8_codec_bit_equal(shape, chunk, k):
    """The config's codec, port ``impl="auto"`` on the CPU against JAX
    ``impl="interpret"``: int8 data, scales and uint16 indices, then both
    decodes (k = 100 is past the kernel's 64: the reference's interpret
    path still runs its kernel, and so does the port's plain version)."""
    rng = np.random.default_rng(chunk + k + shape[0])
    x = rng.normal(size=shape).astype(np.float32)
    acc = rng.normal(size=shape).astype(np.float32)
    tc, jc = topk_int8_compressor(chunk=chunk, k=k, impl="auto"), jax_topk_int8(chunk=chunk, k=k, impl="interpret")
    assert isinstance(tc, ComposedCompressor) and tc.bucket_alignment() == chunk
    tp, jp = tc.compress(torch.from_numpy(x)), jc.compress(jnp.asarray(x))
    _eq(tp.values.data, jp.values.data, "int8 values")
    _eq(tp.values.scales, jp.values.scales, "scales")
    _eq(tp.indices.numpy().astype(np.uint16), jp.indices, "uint16 indices")
    _eq(tc.decompress(tp), jc.decompress(jp), "decompress")
    _eq(tc.decompress_accumulate(tp, torch.from_numpy(acc), 1 / 3),
        jax.jit(lambda p, a: jc.decompress_accumulate(p, a, 1 / 3))(jp, jnp.asarray(acc)), "accumulate")


def test_topk_int8_wire_rates():
    """Bytes per chunk the bucket planner reads (the kernel path's layout:
    the value vector's int8 chunk is never below 128)."""
    full = topk_int8_compressor(chunk=512, k=8, impl="auto")
    smoke = topk_int8_compressor(ratio=0.1, chunk=128, impl="auto")
    assert full.wire_bytes((512,)) == 148  # 128 int8 + 4 scale + 8 x 2 index bytes
    assert smoke.inner.k_per_chunk == 13 and smoke.wire_bytes((128,)) == 158
    assert full.wire_bytes((512,)) == jax_topk_int8(chunk=512, k=8, impl="interpret").wire_bytes((512,), jnp.float32)


@pytest.mark.parametrize("shape", [(300,), (7, 90)])
def test_reference_topk_int8_bit_equal(shape):
    """``impl="reference"``: global top-k + the int8 oracle, against the
    JAX package's jitted, as its engine runs it."""
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[[3, 11]] = [5.0, -5.0]  # a tie at the top
    acc = rng.normal(size=shape).astype(np.float32)
    tc = topk_int8_compressor(ratio=0.1, chunk=16, impl="reference")
    jc = jax_topk_int8(ratio=0.1, chunk=16, impl="reference")
    assert isinstance(tc.inner, TopKCompressor) and tc.bucket_alignment() is None
    tp, jp = tc.compress(torch.from_numpy(x)), jax.jit(jc.compress)(jnp.asarray(x))
    _eq(tp.indices, jp.indices, "indices")
    assert tp.indices[:2].tolist() == [3, 11]
    _eq(tp.values.data, jp.values.data, "int8 values")
    _eq(tp.values.scales, jp.values.scales, "scales")
    _eq(tc.decompress(tp), jax.jit(jc.decompress)(jp), "decompress")
    _eq(tc.decompress_accumulate(tp, torch.from_numpy(acc), 0.5),
        jax.jit(lambda p, a: jc.decompress_accumulate(p, a, 0.5))(jp, jnp.asarray(acc)), "accumulate")
    assert tc.wire_bytes(shape) == jc.wire_bytes(shape, jnp.float32)


def test_stacked_compress_is_per_worker():
    """``compress(x, stacked=True)`` equals compressing each worker's slice
    on its own (the reference's vmap): the value vector of 3 x 8 = 24
    values per worker pads to its own 128-wide int8 chunk."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(4, 3 * 128)).astype(np.float32))
    comp = topk_int8_compressor(chunk=128, k=8, impl="auto")
    p = comp.compress(x, stacked=True)
    assert p.values.data.shape == (4, 128) and p.indices.shape == (4, 3, 8)
    dec = comp.decompress(p)
    assert dec.shape == x.shape
    for w in range(4):
        pw = comp.compress(x[w])
        _eq(p.values.data[w], pw.values.data)
        _eq(p.values.scales[w], pw.values.scales)
        _eq(dec[w], comp.decompress(pw))


def test_codec_refusals():
    with pytest.raises(ValueError):
        ChunkedTopKCompressor(chunk=100)
    with pytest.raises(ValueError):
        ChunkedTopKCompressor(chunk=128, k_per_chunk=0)
    with pytest.raises(ValueError):
        ChunkedTopKCompressor(chunk=2**17, k_per_chunk=8)
    with pytest.raises(ValueError):
        chunked_topk(torch.zeros(4, 128), 0)
    with pytest.raises(ValueError):
        chunk_scatter(torch.zeros(4, 8), torch.zeros(4, 8, dtype=torch.int32), 128, torch.zeros(4, 64))
