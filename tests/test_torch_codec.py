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

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.compress import Int8Compressor as JaxInt8
from consensusml_tpu.compress import PallasInt8Compressor as JaxPallasInt8
from consensusml_tpu.compress import kernels as jk
from consensusml_tpu.compress.kernels import FusedBucketCodec as JaxFusedCodec
from consensusml_tpu.compress.kernels import fused_pack_quantize as jax_fused_pack_quantize
from consensusml_tpu_torch.compress import (
    Compressor,
    Fp8Payload,
    Int4Payload,
    Int8Compressor,
    PallasFp8Compressor,
    PallasInt4Compressor,
    PallasInt8Compressor,
    fused_bucket_codec,
    fused_dequantize_accumulate,
    fused_pack_quantize,
    quantize_int8,
)
from consensusml_tpu_torch.compress.kernels import FusedBucketCodec


F32_MIN = np.float32(2.0**-126)


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
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint32)


def _eq(got, want, what=""):
    got, want = _bits(got), _bits(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


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
    # every format of the reference is ported; an unknown one is refused
    with pytest.raises(ValueError):
        fused_pack_quantize(torch.zeros(2, 128), torch.zeros(2, 128), fmt="int2")
    with pytest.raises(ValueError):
        FusedBucketCodec(fmt="int2", chunk=128)
    assert FusedBucketCodec(fmt="fp8", chunk=128).wire_width == 128
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


def _subnormal_rows(seed, rows, chunk):
    """(x, xhat) with the subnormal hazards of the fused encode in their
    first rows: a subnormal delta over a zero xhat (scale 0), a delta whose
    scale would be subnormal, subnormal deltas beside a tiny normal absmax,
    a subnormal xhat (read as zero: xhat' comes out zero), and a NaN."""
    x, xhat = _rows(seed, rows, chunk)
    col = np.arange(chunk)
    sign = np.where(col % 2, 1, -1).astype(np.float32)
    x[4], xhat[4] = np.float32(1e-39) * sign, 0.0
    x[5], xhat[5] = np.float32(5e-38) * sign, 0.0
    x[6], xhat[6] = np.float32(0.9) * F32_MIN * sign, 0.0
    x[6, 0] = np.float32(127 * 1.5) * F32_MIN
    x[7], xhat[7] = 0.0, np.float32(-2e-39) * sign
    x[8, 3] = np.nan
    return x, xhat


@pytest.mark.parametrize("chunk", [128, 512])
@pytest.mark.parametrize("fmt", ["int4", "fp8"])
def test_fused_encode_formats_bit_equal_to_reference(fmt, chunk):
    """The fused encode's int4 and fp8 formats: wire data (packed nibbles,
    e4m3 codes), scales and the tracked ``xhat'``, with the subnormal and
    NaN hazards."""
    x, xhat = _subnormal_rows(chunk + 1, 40, chunk)
    wq, ws, wh = jax_fused_pack_quantize(jnp.asarray(x), jnp.asarray(xhat), fmt=fmt, interpret=True)
    before = fused_pack_quantize.launches
    q, s, h = fused_pack_quantize(torch.from_numpy(x), torch.from_numpy(xhat), fmt=fmt)
    assert fused_pack_quantize.launches == before  # CPU tensors never launch
    width = chunk // 2 if fmt == "int4" else chunk
    assert q.dtype == {"int4": torch.uint8, "fp8": torch.float8_e4m3fn}[fmt] and q.shape == (40, width)
    _eq(q, wq, "data")
    _eq(s, ws, "scales")
    _eq(h, wh, "xhat'")
    assert s[0] == 0 and s[4] == 0 and s[5] == 0 and not h[7].any() and torch.isnan(s[8])


@pytest.mark.parametrize("fmt", ["int4", "fp8"])
def test_fused_bucket_codec_formats_encode_decode_stacked(fmt):
    """A stacked (W, total) bucket in the int4 and fp8 formats: payload
    class and widths, the reference's payload bits, and the decode."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 8 * 128)).astype(np.float32)
    xhat = (0.5 * x + rng.normal(scale=0.05, size=x.shape)).astype(np.float32)
    jcodec = JaxFusedCodec(fmt=fmt, chunk=128, impl="interpret")
    want_p, want_h = jcodec.encode(jnp.asarray(x), jnp.asarray(xhat))
    codec = FusedBucketCodec(fmt=fmt, chunk=128)
    got_p, got_h = codec.encode(torch.from_numpy(x), torch.from_numpy(xhat))
    assert isinstance(got_p, {"int4": Int4Payload, "fp8": Fp8Payload}[fmt])
    assert got_p.data.shape == (4, codec.wire_width * 8) and got_p.scales.shape == (4, 8)
    _eq(got_p.data, want_p.data, "data")
    _eq(got_p.scales, want_p.scales, "scales")
    _eq(got_h, want_h, "xhat'")
    _eq(codec.decode(got_p), JaxFusedCodec(fmt=fmt, chunk=128, impl="jnp").decode(want_p), "decode")


def _sources(fmt, n, seed, rows=6, chunk=128, spread=True):
    """``s`` and ``n`` payloads of each codec, port and reference; with
    ``spread`` each source at its own magnitude (1e-37 to 1e2)."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(rows * chunk,)).astype(np.float32)
    s[:5] = [np.float32(1e-39), -0.0, np.float32(2e-38), 0.0, np.float32(-3e-39)]  # subnormal s read as zero
    srcs = [((rng.normal(size=(rows * chunk,)) * (10.0 ** rng.integers(-37, 3) if spread else 1.0)).astype(np.float32),
             np.zeros(rows * chunk, np.float32)) for _ in range(n)]
    jcodec = JaxFusedCodec(fmt=fmt, chunk=chunk, impl="jnp")
    jp = [jax.jit(jcodec.encode)(jnp.asarray(x), jnp.asarray(h))[0] for x, h in srcs]
    codec = FusedBucketCodec(fmt=fmt, chunk=chunk)
    tp = [codec.encode(torch.from_numpy(x), torch.from_numpy(h))[0] for x, h in srcs]
    return s, codec, tp, jp


@pytest.mark.parametrize("weights", [(0.3,), (1 / 3, 0.7), (1 / 3, 1 / 3, 1 / 3)], ids=["1src", "2src", "3src"])
@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
def test_decode_accumulate_formats_bit_equal(fmt, weights):
    """``s + sum_j w_j dec(q_j)`` in every format for 1-3 sources at
    inexact weights, against both the reference's jnp path and its Pallas
    kernel (interpret mode), each under jit as the collective round runs
    them. The wrapper's plain version is what runs here."""
    s, codec, tp, jp = _sources(fmt, len(weights), seed=len(weights) + 7)
    before = fused_dequantize_accumulate.launches
    got = codec.decode_accumulate(torch.from_numpy(s), tp, weights)
    assert fused_dequantize_accumulate.launches == before
    for impl in ("jnp", "interpret"):
        jcodec = JaxFusedCodec(fmt=fmt, chunk=128, impl=impl)
        want = jax.jit(lambda s_, ps: jcodec.decode_accumulate(s_, ps, weights))(jnp.asarray(s), jp)
        _eq(got, want, impl)


def test_decode_accumulate_one_source_is_one_fma():
    """With one source the compiled reference computes ``fma(w0, d0, s)``,
    one rounding; ``s + w0 * d0`` (two) differs on a share of the
    elements."""
    s, codec, tp, jp = _sources("int8", 1, seed=31, rows=32, spread=False)
    w = (0.3,)
    jcodec = JaxFusedCodec(fmt="int8", chunk=128, impl="jnp")
    want = jax.jit(lambda s_, ps: jcodec.decode_accumulate(s_, ps, w))(jnp.asarray(s), jp)
    got = codec.decode_accumulate(torch.from_numpy(s), tp, w)
    _eq(got, want)
    two_roundings = torch.from_numpy(s) + torch.tensor(np.float32(0.3)) * codec.decode(tp[0])
    assert (_bits(two_roundings) != _bits(want)).mean() > 0.05


def test_decode_accumulate_wrapper_refuses_malformed_sources():
    s = torch.zeros(2, 128)
    src = (torch.zeros(2, 128, dtype=torch.int8), torch.zeros(2))
    with pytest.raises(ValueError):
        fused_dequantize_accumulate(s, [src], fmt="int8", weights=(0.5, 0.5))
    with pytest.raises(ValueError):
        fused_dequantize_accumulate(s, [], fmt="int8", weights=())
    with pytest.raises(ValueError):
        fused_dequantize_accumulate(s, [src], fmt="int4", weights=(1.0,))  # int4 data is (R, C/2)


@dataclasses.dataclass(frozen=True)
class _Stub(Compressor):
    """A codec that only advertises a fused-wire format and an alignment."""

    fmt: str | None
    align: int | None
    stochastic: bool = False

    def fused_wire(self):
        return self.fmt

    def bucket_alignment(self):
        return self.align

    def compress(self, x, stacked=False):
        raise NotImplementedError

    def decompress(self, payload):
        raise NotImplementedError


def test_fused_bucket_codec_rules():
    """The reference's rules (``compress/kernels.py:1143-1160``): no tag,
    a stochastic codec, no alignment, an alignment below 2 or an odd int4
    one keep the two-step wire (``None``); any other alignment fuses."""
    for comp in (_Stub(None, 128), _Stub("int8", 128, stochastic=True), _Stub("int8", None),
                 _Stub("fp8", 1), _Stub("int4", 129)):
        assert fused_bucket_codec(comp) is None, comp
    for fmt, align in (("int8", 100), ("int4", 130), ("fp8", 7), ("fp8", 512)):
        codec = fused_bucket_codec(_Stub(fmt, align))
        assert (codec.fmt, codec.chunk) == (fmt, align)
    with pytest.raises(ValueError):
        FusedBucketCodec(fmt="int4", chunk=129)
    for comp, fmt in ((PallasInt4Compressor(chunk=512), "int4"), (PallasFp8Compressor(chunk=512), "fp8")):
        codec = fused_bucket_codec(comp)
        assert (codec.fmt, codec.chunk) == (fmt, 512)


def _unflushed_int8(x):
    """The int8 quantizer written as PyTorch computes it, subnormals kept
    (the port's quantizer before the flushes)."""
    absmax = x.abs().amax(1)
    scales = absmax * torch.tensor(np.float32(1 / 127))
    inv = torch.where(scales > 0, 1 / torch.where(scales > 0, scales, 1), 0)
    r = torch.clamp(torch.round(x * inv[:, None]), -127, 127)
    return torch.where(torch.isnan(r), 0, r).to(torch.int8), scales


@pytest.mark.parametrize("path", ["quantize_int8", "int8_codec", "fused_int8"])
def test_subnormal_rows_bit_equal_and_the_unflushed_math_is_not(path):
    """Rows that meet f32 subnormals through the int8 quantizer, the int8
    codecs and the int8 fused encode: the port equals the reference (a row
    of 1e-39 has scale 0 and codes 0), and the same math with subnormals
    kept (PyTorch's default, the port before it flushed) does not (codes
    of 127 for that row)."""
    x, xhat = _subnormal_rows(5, 12, 128)
    xt, ht = torch.from_numpy(x), torch.from_numpy(xhat)
    if path == "quantize_int8":
        wq, ws = jk.quantize_int8(jnp.asarray(x), interpret=True)
        q, sc = quantize_int8(xt)
        naive_q, naive_s = _unflushed_int8(xt)
    elif path == "int8_codec":
        flat = x.reshape(-1)
        want = jax.jit(JaxInt8(chunk=128).compress)(jnp.asarray(flat))
        wq, ws = want.data, want.scales
        got = Int8Compressor(chunk=128).compress(torch.from_numpy(flat))
        q, sc = got.data, got.scales
        _eq(Int8Compressor(chunk=128).decompress(got), jax.jit(JaxInt8(chunk=128).decompress)(want), "decode")
        naive_q, naive_s = _unflushed_int8(xt)
        naive_q = naive_q.reshape(-1)
    else:
        wq, ws, wh = jax_fused_pack_quantize(jnp.asarray(x), jnp.asarray(xhat), fmt="int8", interpret=True)
        q, sc, h = fused_pack_quantize(xt, ht)
        _eq(h, wh, "xhat'")
        naive_q, naive_s = _unflushed_int8(xt - ht)
        naive_h = (naive_q.double() * naive_s[:, None].double() + ht.double()).float()
        assert (_bits(naive_h) != _bits(wh)).any()
    _eq(q, wq, "codes")
    _eq(sc, ws, "scales")
    assert (_bits(naive_q) != _bits(wq)).any() and (_bits(naive_s) != _bits(ws)).any()
    assert sc[4] == 0 and not q.reshape(12, 128)[4].any()
